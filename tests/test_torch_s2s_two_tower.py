"""The S2S and two-tower families, port vs JAX package, on the CPU: S2S's
two heads' logits, its loss and ``generate`` on both heads; the two-tower
loss with every gradient and ``generate``; both fed JAX's Gumbel draws;
the reference's right-padded prefill (a fault of the JAX package, which
the port does not copy); the collators; the S2S vocabulary enlargement and
the RWKV-7 converters for towers without a head or an embedding.

The configs are tests/test_tts_s2s.py's (hidden 32, head 8, 1-2 layers),
f32. The weights are JAX's init tree with values drawn by numpy from a
seed, carried to the port by the bridge. Tolerances: forward values 1e-5
relative, gradients 1e-4 relative to each leaf's largest, tokens exact."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from rwkvtts_tpu.convert import export_hf as jexport
from rwkvtts_tpu.convert import rwkv7_ckpt as jckpt
from rwkvtts_tpu.convert import speech_init as jinit
from rwkvtts_tpu.data import s2s_collator as jcoll
from rwkvtts_tpu.models import rwkv7 as jrwkv7
from rwkvtts_tpu.models import s2s as js2s
from rwkvtts_tpu.models import tts_two_tower as jtt
from rwkvtts_torch import bridge
from rwkvtts_torch.convert import export_hf, rwkv7_ckpt, speech_init
from rwkvtts_torch.data import s2s_collator
from rwkvtts_torch.models import rwkv7, s2s
from rwkvtts_torch.models import tts_two_tower as tt

from test_torch_asr import _compiled

torch.set_num_threads(2)

RTOL, GRAD_RTOL = 1e-5, 1e-4
TINY = dict(head_size=8, gate_lora=8)
JAX_ONLY = dict(wkv_chunk=4, remat=False)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _weights(init, jcfg, seed, to_port):
    """`init`'s tree (jax.eval_shape: names and shapes, nothing compiled),
    values drawn with numpy from `seed`: norm scales 1 + U(-0.1, 0.1),
    matrices U within 1/sqrt(fan_in), other vectors U(-0.1, 0.1).
    Returns (JAX tree, port tree through `to_port`)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if jax.tree_util.keystr(path).endswith("scale']"):
            return (1 + rng.uniform(-0.1, 0.1, leaf.shape)).astype(np.float32)
        bound = 1 / np.sqrt(leaf.shape[-2]) if len(leaf.shape) >= 2 else 0.1
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)

    shapes = jax.eval_shape(lambda k: init(k, jcfg), jax.random.PRNGKey(0))
    npp = jax.tree_util.tree_map_with_path(fill, shapes)
    return jax.tree.map(jnp.asarray, npp), to_port(npp)


def _gumbel(key, steps, B, width):
    """The draws of JAX's generate loops: split(key, steps), one Gumbel
    (B, width) a step, width the sampler's candidates."""
    return torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(k, (B, width), jnp.float32))
                                      for k in jax.random.split(key, steps)]))


_S2S_GEN = jax.jit(js2s.generate, static_argnums=(1,), static_argnames=(
    "is_text", "max_new_tokens", "temperature", "top_k", "top_p", "eos_id"))
_TT_GEN = jax.jit(jtt.generate, static_argnums=(1, 5, 6, 7, 8))
_S2S_FWD = jax.jit(js2s.forward, static_argnums=(1,), static_argnames=("is_text",))


def test_s2s_matches_jax():
    """Named checks: both heads' logits within 1e-5 (right-padded rows
    too); the loss on either head within 1e-5; generate on the text head
    (temperature 1, the full vocabulary) and the audio head (top-k 5, top-p
    0.9, audio ids offset on the input side) given JAX's draws: tokens and
    lengths exact. The reference's fault: JAX's greedy generate of a
    right-padded short row differs from the row alone (its prefill runs
    through the pads); the port's equals it, and on a left-padded batch
    the port equals JAX's."""
    kw = dict(hidden_size=32, num_layers=2, vocab_size=64, text_vocab=40, audio_vocab=24, **TINY)
    jcfg = js2s.default_config(dtype=jnp.float32, **kw, **JAX_ONLY)
    tcfg = s2s.default_config(dtype=torch.float32, **kw)
    jp, tp = _weights(js2s.init_params, jcfg, 0, bridge.s2s_params_from_numpy)
    assert "head" in tp and "audio_head" in tp and tp["embedding"].shape == (64, 32)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 64, (3, 8))
    mask = np.ones((3, 8), np.int32)
    mask[2, 5:] = 0
    labels = rng.integers(0, 24, (3, 8))
    T = lambda a: torch.from_numpy(a)
    B, n = 3, 8
    # row 2 is 5 tokens, right-padded to 8 as collate_s2s pads; greedy
    greedy = dict(is_text=False, max_new_tokens=n, temperature=0.0, eos_id=-1)
    key = jax.random.PRNGKey(0)
    sampled = ((True, dict(top_k=0, top_p=1.0), 40), (False, dict(top_k=5, top_p=0.9), 5))
    jids, jmask = jnp.asarray(ids), jnp.asarray(mask)
    jobs = {"alone": (_S2S_GEN, (jp, jcfg, jnp.asarray(ids[2:, :5]), key), greedy),
            "padded": (_S2S_GEN, (jp, jcfg, jids, key), dict(greedy, attention_mask=jmask))}
    for is_text, gen_kw, _ in sampled:
        lab = jnp.asarray(labels % (40 if is_text else 24))
        jobs["forward", is_text] = (_S2S_FWD, (jp, jcfg, jids, jmask), dict(is_text=is_text))
        jobs["loss", is_text] = (_S2S_FWD, (jp, jcfg, jids, jmask),
                                 dict(is_text=is_text, labels=lab))
        jobs["generate", is_text] = (_S2S_GEN, (jp, jcfg, jids, jax.random.PRNGKey(2 if is_text else 3)),
                                     dict(is_text=is_text, max_new_tokens=n, temperature=1.0,
                                          eos_id=3, **gen_kw))
    programs = _compiled(jobs)
    for is_text in (True, False):
        got = s2s.forward(tp, tcfg, T(ids), T(mask), is_text=is_text)
        want = programs["forward", is_text](jp, jids, jmask)
        assert got.shape == (3, 8, 40 if is_text else 24) and _rel(got, want) <= RTOL
        lab = labels % (40 if is_text else 24)
        loss_t, n_t = s2s.forward(tp, tcfg, T(ids), T(mask), is_text=is_text, labels=T(lab))
        loss_j, n_j = programs["loss", is_text](jp, jids, jmask, labels=jnp.asarray(lab))
        assert int(n_t) == int(n_j) and _rel(loss_t.item(), float(loss_j)) <= RTOL

    for is_text, gen_kw, width in sampled:
        key = jax.random.PRNGKey(2 if is_text else 3)
        toks_j, len_j = programs["generate", is_text](jp, jids, key)
        toks_t, len_t = s2s.generate(tp, tcfg, T(ids), is_text=is_text, max_new_tokens=n,
                                     temperature=1.0, eos_id=3, noise=_gumbel(key, n, B, width),
                                     **gen_kw)
        np.testing.assert_array_equal(toks_t.numpy(), np.asarray(toks_j))
        np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))

    key = jax.random.PRNGKey(0)
    alone_j, _ = programs["alone"](jp, jnp.asarray(ids[2:, :5]), key)
    padded_j, _ = programs["padded"](jp, jids, key, attention_mask=jmask)
    assert not np.array_equal(np.asarray(padded_j)[2], np.asarray(alone_j)[0])
    alone_t, _ = s2s.generate(tp, tcfg, T(ids[2:, :5]), **greedy)
    padded_t, _ = s2s.generate(tp, tcfg, T(ids), attention_mask=T(mask), **greedy)
    np.testing.assert_array_equal(alone_t.numpy(), np.asarray(alone_j))
    np.testing.assert_array_equal(padded_t[2].numpy(), alone_t[0].numpy())
    left = np.ascontiguousarray(mask[:, ::-1])
    np.testing.assert_array_equal(
        s2s.generate(tp, tcfg, T(ids), attention_mask=T(left), **greedy)[0].numpy(),
        np.asarray(programs["padded"](jp, jids, key, attention_mask=jnp.asarray(left))[0]))


def test_two_tower_matches_jax():
    """Named checks: the packed [text][audio] loss within 1e-5 and every
    gradient within 1e-4 of jax.value_and_grad (padded rows); generate at
    its defaults (top-k 50, top-p 0.95) on an unpadded batch given JAX's
    draws: tokens and lengths exact, every token in the audio vocabulary.
    The reference's fault: JAX's generate (top-k 1: greedy) of a
    right-padded short prompt differs from the prompt alone; the port's
    equals it."""
    kw = dict(text_hidden=32, text_layers=1, audio_hidden=32, audio_layers=2, **TINY)
    jcfg = jtt.default_config(dtype=jnp.float32, **kw, **JAX_ONLY)
    tcfg = tt.default_config(dtype=torch.float32, **kw)
    jp, tp = _weights(jtt.init_params, jcfg, 4, bridge.two_tower_params_from_numpy)
    assert "head" not in tp["text_lm"] and "head" in tp["audio_lm"]
    rng = np.random.default_rng(5)
    text_ids = rng.integers(0, 100, (2, 5))
    text_mask = np.array([[0, 1, 1, 1, 1], [1, 1, 1, 1, 0]], np.int32)
    audio_ids = rng.integers(0, tt.AUDIO_VOCAB, (2, 6))
    audio_mask = np.array([[0, 0, 1, 1, 1, 1], [1, 1, 1, 1, 1, 0]], np.int32)
    labels = np.where(audio_mask > 0, audio_ids, -100)
    args = [text_ids, text_mask, audio_ids, audio_mask, labels]
    B, n = 2, 8
    ones = np.ones((B, 5), np.int32)
    key = jax.random.PRNGKey(6)
    # row 1's prompt is 4 tokens, right-padded to 5 as collate_two_tower pads
    pad_mask = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 1, 0]], np.int32)
    jids = jnp.asarray(text_ids)
    programs = _compiled({
        "loss": (jax.jit(jax.value_and_grad(lambda p, *a: jtt.forward(p, jcfg, *a)[0])),
                 (jp, *map(jnp.asarray, args))),
        "generate": (_TT_GEN, (jp, jcfg, jids, jnp.asarray(ones), key, n, 1.0, 50, 0.95)),
        "alone": (_TT_GEN, (jp, jcfg, jnp.asarray(text_ids[1:, :4]), jnp.ones((1, 4), jnp.int32),
                            key, n, 1.0, 1, 0.95)),
        "padded": (_TT_GEN, (jp, jcfg, jids, jnp.asarray(pad_mask), key, n, 1.0, 1, 0.95))},
        options={})

    loss_j, grads_j = programs["loss"](jp, *map(jnp.asarray, args))
    leaves = rwkv7.tree_map(lambda t: t.clone().requires_grad_(), tp)
    loss_t, n_t = tt.forward(leaves, tcfg, *map(torch.from_numpy, args))
    loss_t.backward()
    assert int(n_t) == int((labels != -100).sum())
    assert abs(loss_t.item() - float(loss_j)) <= RTOL * abs(float(loss_j))
    gj = dict(_leaves(jax.tree.map(np.asarray, grads_j)))
    for path, t in _leaves(leaves):
        g = np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy()
        err = np.abs(g - gj[path]).max()
        assert err <= GRAD_RTOL * max(np.abs(gj[path]).max(), 1e-6), (path, err)

    toks_j, len_j = programs["generate"](jp, jids, jnp.asarray(ones), key)
    toks_t, len_t = tt.generate(tp, tcfg, torch.from_numpy(text_ids), torch.from_numpy(ones),
                                max_new_tokens=n, noise=_gumbel(key, n, B, 50))
    np.testing.assert_array_equal(toks_t.numpy(), np.asarray(toks_j))
    np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))
    assert int(toks_t.max()) < tt.AUDIO_VOCAB

    alone_j, _ = programs["alone"](jp, jnp.asarray(text_ids[1:, :4]), jnp.ones((1, 4), jnp.int32),
                                   key)
    padded_j, _ = programs["padded"](jp, jids, jnp.asarray(pad_mask), key)
    assert not np.array_equal(np.asarray(padded_j)[1], np.asarray(alone_j)[0])
    greedy = dict(max_new_tokens=n, top_k=1, generator=torch.Generator().manual_seed(0))
    alone_t, _ = tt.generate(tp, tcfg, torch.from_numpy(text_ids[1:, :4]),
                             torch.ones(1, 4, dtype=torch.int32), **greedy)
    padded_t, _ = tt.generate(tp, tcfg, torch.from_numpy(text_ids), torch.from_numpy(pad_mask),
                              **greedy)
    np.testing.assert_array_equal(alone_t.numpy(), np.asarray(alone_j))
    np.testing.assert_array_equal(padded_t[1].numpy(), alone_t[0].numpy())


class StubTokenizer:
    def encode(self, text):
        return [1 + ord(c) % 97 for c in text]


def test_collators_and_converters():
    """Named checks: collate_s2s (text and audio mode, 2-D audio tokens,
    pad_to) and collate_two_tower = JAX's; s2s_enlarge_vocab = JAX's on one
    BlinkDL text checkpoint and numpy seed; the RWKV-7 converters honour
    with_head / with_embedding as JAX's do, both ways, and a tower without
    a head or an embedding runs forward and a decode step."""
    tok = StubTokenizer()
    rows = [{"text": "hello there", "audio_tokens": [[1, 2, 3], [4, 5, 6]],
             "global_tokens": [7, 8], "semantic_tokens": [9, 10, 11]},
            {"text": "hi", "audio_tokens": [5, 6, 7, 8, 9],
             "global_tokens": [1, 2], "semantic_tokens": [3]}]
    for got, want in (
            (s2s_collator.collate_s2s(rows, tok), jcoll.collate_s2s(rows, tok)),
            (s2s_collator.collate_s2s(rows, tok, is_text=False, text_vocab=40, pad_to=4),
             jcoll.collate_s2s(rows, tok, is_text=False, text_vocab=40, pad_to=4)),
            (s2s_collator.collate_two_tower(rows, tok, pad_audio_to=8),
             jcoll.collate_two_tower(rows, tok, pad_audio_to=8))):
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    kw = dict(hidden_size=32, num_layers=2, vocab_size=64, text_vocab=40, audio_vocab=24, **TINY)
    jcfg = js2s.default_config(dtype=jnp.float32, **kw, **JAX_ONLY)
    tcfg = s2s.default_config(dtype=torch.float32, **kw)
    text_cfg = jrwkv7.RWKV7Config(vocab_size=40, hidden_size=32, num_layers=2, **TINY)
    npp, _ = _weights(jrwkv7.init_params, text_cfg, 7, bridge.params_from_numpy)
    blink = jckpt.rwkv7_to_blinkdl(jax.tree.map(np.asarray, npp), text_cfg)
    got = speech_init.s2s_enlarge_vocab(blink, tcfg, np.random.default_rng(8))
    want = jinit.s2s_enlarge_vocab(blink, jcfg, np.random.default_rng(8))
    assert dict(_leaves(got)).keys() == dict(_leaves(want)).keys()
    for k, v in _leaves(got):
        np.testing.assert_array_equal(v, dict(_leaves(want))[k], err_msg=k)
    assert got["embedding"].shape == (64, 32) and got["audio_head"].shape == (32, 24)

    fla = jexport.rwkv7_to_fla(jax.tree.map(np.asarray, npp), text_cfg)
    for flags in (dict(with_head=False), dict(with_embedding=False)):
        tc = rwkv7.RWKV7Config(vocab_size=40, hidden_size=32, num_layers=2,
                               dtype=torch.float32, **TINY, **flags)
        jc = jrwkv7.RWKV7Config(vocab_size=40, hidden_size=32, num_layers=2, **TINY, **flags)
        got = rwkv7_ckpt.fla_to_rwkv7(fla, tc)
        want = jckpt.fla_to_rwkv7(fla, jc)
        assert dict(_leaves(got)).keys() == dict(_leaves(want)).keys()
        assert ("head" in got) == tc.with_head and ("embedding" in got) == tc.with_embedding
        # the export writes what the flags allow, as JAX's of JAX's loaded tree
        sd = export_hf.rwkv7_to_fla(bridge.params_from_numpy(jax.tree.map(np.asarray, npp)), tc)
        assert sd.keys() == jexport.rwkv7_to_fla(want, jc).keys()
        tower = rwkv7.init_params(torch.Generator().manual_seed(9), tc)
        assert ("head" in tower) == tc.with_head and ("embedding" in tower) == tc.with_embedding
        x = torch.randn(2, 3, 32, generator=torch.Generator().manual_seed(10))
        h, state = rwkv7.forward(tower, tc, inputs_embeds=x, return_state=True)
        h2, _ = rwkv7.decode_step(rwkv7.layer_decode_views(tower, tc), tc, x[:, 0],
                                  rwkv7.pack_decode_state(state, tc))
        assert h.shape == (2, 3, 32) and h2.shape == (2, 32)
