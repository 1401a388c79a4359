"""The XY 8-channel LM slice, port vs JAX package, on the CPU: the model
(init tree, forward hidden states and the summed loss), the collator, the
converters, and ``xy_generate`` on both backbone routes fed JAX's Gumbel
draws: the model's decode step, and the B=64 whole-step kernel (JAX side
through its Pallas kernel in interpret mode, port side through
``decode_step_plain``). One set of weights a config, drawn by the port's
init from a seed and carried across as numpy (the trees' names and
layouts are the same in both packages)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkvtts_tpu.convert import export_hf as jexport
from rwkvtts_tpu.convert import speech_init as jinit
from rwkvtts_tpu.data import xy_collator as jcoll
from rwkvtts_tpu.infer import generate as jgen
from rwkvtts_tpu.models import xy as jxy
from rwkvtts_tpu.ops import decode_mega_b64 as jdmb
from rwkvtts_torch import bridge
from rwkvtts_torch.convert import export_hf, speech_init
from rwkvtts_torch.data import xy_collator
from rwkvtts_torch.infer import generate as tgen
from rwkvtts_torch.models import rwkv7, xy
from rwkvtts_torch.ops import decode_mega_b64 as tdmb

torch.set_num_threads(2)

# the reduced vocabularies of tests/test_xy.py and tests/test_decode_mega_b64.py:222-229
VOCAB = dict(text_vocab_size=700, speech_vocab_size=32, text_shift_size=600)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _configs(C, L, head_size=64, gate_lora=128, **jkw):
    jcfg = dataclasses.replace(
        jxy.default_config(hidden_size=C, num_layers=L, head_size=head_size,
                           gate_lora=gate_lora, dtype=jnp.float32, remat=False, **jkw), **VOCAB)
    tcfg = dataclasses.replace(
        xy.default_config(hidden_size=C, num_layers=L, head_size=head_size,
                          gate_lora=gate_lora, dtype=torch.float32), **VOCAB)
    return jcfg, tcfg


def _weights(tcfg, seed, heads_scale=1.0):
    """One set of LM weights in both packages' trees (the same names and
    layouts): the port's init from `seed` (the JAX init's distributions;
    XLA compiles JAX's for seconds), heads scaled, as numpy for JAX."""
    tp = xy.init_params(torch.Generator().manual_seed(seed), tcfg)
    tp["heads"] = {k: heads_scale * v for k, v in tp["heads"].items()}
    npp = bridge.params_to_numpy(tp)
    return jax.tree.map(jnp.asarray, npp), bridge.params_from_numpy(npp)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = bridge.to_numpy(v)
    return out


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _jax_draws(key, steps, B, widths):
    per = jax.vmap(lambda k: jax.random.split(k, len(widths)))(jax.random.split(key, steps))
    return [jax.vmap(lambda k, w=w: jax.random.gumbel(k, (B, w), jnp.float32))(per[:, c])
            for c, w in enumerate(widths)]


def jax_noise(key, steps, B, widths):
    """JAX xy_generate's draws: split(key, steps), each step's key split in
    8, one Gumbel (B, V_c) a channel; as the port's per-channel list."""
    return [torch.tensor(np.asarray(n)) for n in _jax_draws(key, steps, B, tuple(widths))]


def _widths(cfg):
    return [cfg.text_vocab_size] + [cfg.speech_vocab_size] * (cfg.num_channels - 1)


def _prompt(cfg, B, T, seed):
    """(B, T, 8) left-padded text prompts: pads everywhere, text ids on
    channel 0 after each row's pad."""
    rng = np.random.default_rng(seed)
    ids = np.full((B, T, 8), cfg.speech_pad_id, np.int64)
    ids[:, :, 0] = cfg.text_pad_id
    mask = np.ones((B, T), np.int32)
    for b, n in enumerate(rng.integers(0, T // 2, B)):
        ids[b, n:, 0] = rng.integers(1, 500, T - n)
        mask[b, :n] = 0
    return ids, mask


class StubTokenizer:
    def encode(self, text):
        return [ord(c) % 300 for c in text][:20]


def test_xy_model_collator_converters_match_jax(tmp_path):
    """Named checks at hidden 32 x 2 layers, head 8 (tests/test_xy.py's
    config), f32: the init tree; forward's hidden states and summed loss,
    with and without label smoothing, within 1e-5; the collator identical,
    with its round trip; the XY export / import round trip and JAX's
    export; init from a text model given one numpy seed."""
    jcfg, tcfg = _configs(32, 2, head_size=8, gate_lora=16, wkv_chunk=16)
    jp, tp = _weights(tcfg, 0)
    npp = jax.tree.map(np.asarray, jp)

    # init: the JAX init's tree, shapes and dtype; pad rows zero
    want = _flat(npp)
    shapes = jax.eval_shape(lambda k: jxy.init_params(k, jcfg), jax.random.PRNGKey(0))
    assert want.keys() == _flat(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)).keys()
    for k, v in _flat(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)).items():
        assert want[k].shape == v.shape and want[k].dtype == v.dtype == np.float32, k
    assert not want["embs/0"][tcfg.text_pad_id].any()
    assert all(not want[f"embs/{i}"][tcfg.speech_pad_id].any() for i in range(1, 8))

    # collator: identical arrays, and undo_diagonal inverts build_sample
    rows = [{"text": "ab", "audio_tokens": np.random.default_rng(1).integers(0, 30, (8, 6))},
            {"text": "cdef", "audio_tokens": np.random.default_rng(2).integers(0, 30, (8, 4))}]
    kw = dict(num_channels=8, text_shift_size=600, speech_vocab_size=32, text_vocab_size=700)
    jb = jcoll.collate(rows, StubTokenizer(), pad_to=32, **kw)
    tb = xy_collator.collate(rows, StubTokenizer(), pad_to=32, **kw)
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    np.testing.assert_array_equal(xy_collator.collate(rows, StubTokenizer(), **kw)["labels"],
                                  jcoll.collate(rows, StubTokenizer(), **kw)["labels"])
    speech = rows[0]["audio_tokens"]
    ids, labels = xy_collator.build_sample([5], speech, **{k: v for k, v in kw.items()})
    jids, jlabels = jcoll.build_sample([5], speech, **kw)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(labels, jlabels)
    undo = xy_collator.undo_diagonal(ids[1:], text_shift_size=600)
    np.testing.assert_array_equal(undo, speech)
    np.testing.assert_array_equal(undo, jcoll.undo_diagonal(jids[1:], text_shift_size=600))

    # forward: hidden states and the summed loss, f32
    ids_j, lab_j, mask_j = (jnp.asarray(tb[k]) for k in ("input_ids", "labels", "attention_mask"))
    ids_t, lab_t, mask_t = (torch.from_numpy(tb[k]) for k in ("input_ids", "labels",
                                                             "attention_mask"))
    jforward = jax.jit(jxy.forward, static_argnums=1)
    h_j = jforward(jp, jcfg, ids_j, attention_mask=mask_j)
    h_t = xy.forward(tp, tcfg, ids_t, attention_mask=mask_t)
    assert _rel(h_t.numpy(), h_j) <= 1e-5
    for lsm in (0.0, 0.1):
        jc = dataclasses.replace(jcfg, lsm_weight=lsm)
        tc = dataclasses.replace(tcfg, lsm_weight=lsm)
        loss_j, n_j = jforward(jp, jc, ids_j, labels=lab_j, attention_mask=mask_j)
        loss_t, n_t = xy.forward(tp, tc, ids_t, labels=lab_t, attention_mask=mask_t)
        assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * abs(float(loss_j)), lsm
        assert int(n_t) == int(n_j)
    # input dropout draws from its generator: the same generator seed, the same loss
    dc = dataclasses.replace(tcfg, drop_ratio=0.5)
    runs = [float(xy.forward(tp, dc, ids_t, labels=lab_t, attention_mask=mask_t,
                             dropout_generator=torch.Generator().manual_seed(3))[0])
            for _ in range(2)]
    assert runs[0] == runs[1] != float(loss_t)

    # export: JAX's state dict, and back through the importer
    sd = export_hf.xy_to_fla(tp, tcfg)
    jsd = jexport.xy_to_fla(npp, jcfg)
    assert sd.keys() == jsd.keys()
    for k in sd:
        np.testing.assert_array_equal(sd[k], jsd[k], err_msg=k)
    back = _flat(speech_init.xy_from_pretrained_sd(sd, tcfg))
    jback = _flat(jax.tree.map(np.asarray, jinit.xy_from_pretrained_sd(jsd, jcfg)))
    assert back.keys() == want.keys()
    for k in want:  # the fla layout has no value lora in layer 0: zeros there
        first = 1 if k in ("blocks/att/v0", "blocks/att/v1", "blocks/att/v2") else 0
        np.testing.assert_array_equal(back[k][first:], want[k][first:], err_msg=k)
        np.testing.assert_array_equal(back[k], jback[k], err_msg=k)
    export_hf.save_pretrained(tp, tcfg, str(tmp_path), kind="xy")
    assert {p.name for p in tmp_path.iterdir()} == {"model.safetensors", "config.json"}

    # init from a text RWKV-7 (vocab 20 < 700), one numpy seed on both sides
    tbb = rwkv7.RWKV7Config(vocab_size=20, hidden_size=32, num_layers=2, head_size=8,
                            gate_lora=16, dtype=torch.float32)
    text_sd = export_hf.rwkv7_to_fla(rwkv7.init_params(torch.Generator().manual_seed(6), tbb),
                                     tbb)
    out = _flat(speech_init.xy_from_text(text_sd, tp, tcfg, np.random.default_rng(4)))
    jout = _flat(jax.tree.map(np.asarray, jinit.xy_from_text(text_sd, npp, jcfg,
                                                              np.random.default_rng(4))))
    assert out.keys() == jout.keys()
    for k in out:
        np.testing.assert_array_equal(out[k], jout[k], err_msg=k)
    np.testing.assert_array_equal(out["embs/0"][:20], text_sd["model.embeddings.weight"])


@pytest.fixture(scope="module")
def small_lm():
    """hidden 32 x 2, head 8, f32, the reduced vocabularies; the heads x 4
    so that channel 0's EOS is drawn within a few steps."""
    jcfg, tcfg = _configs(32, 2, head_size=8, gate_lora=16, wkv_chunk=16)
    return (jcfg, tcfg) + _weights(tcfg, 1, heads_scale=4.0)


@pytest.mark.parametrize("temperature,min_new,allow_eos", [(1.0, 2, True), (0.01, 3, False)])
def test_xy_generate_decode_step_matches_jax(small_lm, temperature, min_new, allow_eos):
    """The rwkv7.decode_step route fed JAX's Gumbel draws: frames and
    n_audio equal JAX's xy_generate exactly (B=4, 12 steps): sampled with
    the EOS held back for 2 steps, the flush reached; near-greedy with no
    EOS at all."""
    jcfg, tcfg, jp, tp = small_lm
    B, steps = 4, 12
    ids, mask = _prompt(tcfg, B, 6, seed=5)
    key = jax.random.PRNGKey(7)
    f_j, n_j = jgen.xy_generate(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask), key,
                                max_new_tokens=steps, min_new_tokens=min_new,
                                temperature=temperature, allow_eos=allow_eos)
    f_t, n_t = tgen.xy_generate(
        tp, tcfg, torch.from_numpy(ids), torch.from_numpy(mask), max_new_tokens=steps,
        min_new_tokens=min_new, temperature=temperature, allow_eos=allow_eos,
        noise=jax_noise(key, steps, B, _widths(tcfg)))
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    ch0 = f_t[..., 0].numpy()
    lo, hi = tcfg.text_shift_size, tcfg.text_shift_size + tcfg.speech_vocab_size
    assert ((ch0 >= lo) & (ch0 < hi) | (ch0 == tcfg.text_pad_id)).all()
    assert ((ch0[:, :min_new] >= lo) & (ch0[:, :min_new] < hi)).all()
    if allow_eos:
        assert (n_t < steps).any()  # the flush is reached
    else:
        assert (n_t == steps).all()


def test_xy_generate_mega_b64_matches_jax():
    """The B=64 whole-step kernel route (port: decode_step_plain on the
    CPU), hidden 128 x 2, temperature 0.01, heads x 10, 5 steps: frames
    and n_audio equal JAX's xy_generate(mega=...) (its Pallas kernel in
    interpret mode) and the port's own decode_step route fed the same
    draws; another batch than 64 is refused."""
    jcfg, tcfg = _configs(128, 2, wkv_chunk=4)
    jp, tp = _weights(tcfg, 2, heads_scale=10.0)
    jmega = jdmb.pack_mega_b64(jp, jcfg.backbone, tile_n=128)
    spec = jmega.pop("spec")
    tmega = tdmb.pack_mega_b64(tp, tcfg.backbone)
    B, steps = 64, 5
    ids, mask = _prompt(tcfg, B, 6, seed=8)
    key = jax.random.PRNGKey(9)
    f_j, n_j = jgen.xy_generate(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask), key,
                                max_new_tokens=steps, min_new_tokens=1, temperature=0.01,
                                mega=jmega, mega_spec=spec)
    noise = jax_noise(key, steps, B, _widths(tcfg))
    args = (tp, tcfg, torch.from_numpy(ids), torch.from_numpy(mask))
    kw = dict(max_new_tokens=steps, min_new_tokens=1, temperature=0.01, noise=noise)
    f_m, n_m = tgen.xy_generate(*args, mega=tmega, **kw)
    f_s, n_s = tgen.xy_generate(*args, **kw)
    np.testing.assert_array_equal(f_m.numpy(), np.asarray(f_j))
    np.testing.assert_array_equal(n_m.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(f_s.numpy(), f_m.numpy())
    np.testing.assert_array_equal(n_s.numpy(), n_m.numpy())
    with pytest.raises(ValueError, match="B=64"):
        tgen.xy_generate(tp, tcfg, *(torch.from_numpy(a[:8]) for a in (ids, mask)),
                         mega=tmega, **kw)
