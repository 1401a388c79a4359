"""The XY slice's codecs and pipeline, port vs JAX package, on the CPU, in
f32: XY_Tokenizer (encode / decode and their windowed long forms), the
Higgs codec (encode / decode), the HuBERT teacher of a saved tiny random
model, both checkpoint importers on one synthetic state dict each, and
``XYPipeline`` with either codec fed JAX's draws. Small configs (those of
tests/test_pipelines.py, with 8 quantizers); one set of weights a codec,
in the JAX package's tree, drawn from a numpy seed and carried across by
the bridge.
The JAX references are compiled whole (``jax.jit``), not op by op."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkvtts_tpu.codecs import higgs as jhiggs
from rwkvtts_tpu.codecs import higgs_import as jhiggs_import
from rwkvtts_tpu.codecs import xy_import as jxy_import
from rwkvtts_tpu.codecs import xy_tokenizer as jxt
from rwkvtts_tpu.infer.xy_pipeline import XYPipeline as JXYPipeline
from rwkvtts_tpu.models import rwkv7 as jrwkv7
from rwkvtts_tpu.models import xy as jxy
from rwkvtts_torch import bridge
from rwkvtts_torch.codecs import higgs, higgs_import, nn, xy_import
from rwkvtts_torch.codecs import xy_tokenizer as xt
from rwkvtts_torch.convert import export_hf
from rwkvtts_torch.infer.xy_pipeline import XYPipeline, xy_text_tokenizer
from rwkvtts_torch.models import rwkv7, xy

torch.set_num_threads(2)

XY_SMALL = dict(n_mels=16, d_model=32, enc_layers=1, heads=2, ffn_dim=64, adapter_layers=1,
                nq=8, codebook_size=16, codebook_dim=8, rvq_dim=16, quantizer_io_dim=32 * 4,
                dec_layers=1, vocos_dim=32, vocos_intermediate_dim=64, vocos_layers=1,
                vocos_n_fft=64, vocos_hop=16)
HIGGS_SMALL = dict(d_model=8, latent_dim=16, semantic_dim=16, nq=8, codebook_size=16,
                   strides=(2, 2, 2), decoder_channels=16)
# 3 s windows stepping by 2 s: the long forms' windowing at a small size
LONG = dict(window_seconds=3.0, overlap_seconds=1.0)

jxt_jit = {name: jax.jit(getattr(jxt, name), static_argnums=1) for name in ("encode", "decode")}
jxt_jit["whisper_log_mel"] = jax.jit(jxt.whisper_log_mel,
                                     static_argnames=("sample_rate", "n_fft", "hop", "n_mels"))
jhiggs_jit = {name: jax.jit(getattr(jhiggs, name), static_argnums=1)
              for name in ("encode", "decode")}


def _jax_tree(init, cfg, seed):
    """A JAX codec tree with `init`'s structure and shapes (jax.eval_shape,
    nothing compiled: XLA takes seconds over these inits), its values
    drawn with numpy from `seed`: matrices and kernels uniform within
    1/sqrt(fan_in), codebooks standard normal, norm gains and snake alphas
    1 + U(-0.1, 0.1), the other vectors U(-0.1, 0.1)."""
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


jpack_decode_params = jax.jit(jrwkv7.pack_decode_params, static_argnums=1)


@pytest.fixture
def jit_jax_codecs(monkeypatch):
    """The JAX codecs' module functions (and the decode packing of its
    XYPipeline) replaced by their compiled forms, so that its decode_long /
    encode_long / XYPipeline call them whole."""
    for name, fn in jxt_jit.items():
        monkeypatch.setattr(jxt, name, fn)
    for name, fn in jhiggs_jit.items():
        monkeypatch.setattr(jhiggs, name, fn)
    monkeypatch.setattr(jrwkv7, "pack_decode_params", jpack_decode_params)


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _jax_draws(key, steps, B, widths):
    """JAX xy_generate's draws: split(key, steps), each step's key split in
    8, one Gumbel (B, V_c) a channel."""
    per = jax.vmap(lambda k: jax.random.split(k, len(widths)))(jax.random.split(key, steps))
    return [jax.vmap(lambda k, w=w: jax.random.gumbel(k, (B, w), jnp.float32))(per[:, c])
            for c, w in enumerate(widths)]


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], bridge.to_numpy(tree)


def _same_trees(a, b, rtol=0.0):
    """Same leaf names and shapes, values equal (or within `rtol`)."""
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].shape == lb[k].shape, k
        np.testing.assert_allclose(la[k], lb[k], rtol=rtol, atol=rtol / 10, err_msg=k)


def _clip(seconds, sr=16000, seed=0):
    t = np.arange(int(seconds * sr)) / sr
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.shape)
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# reference-format state dicts written from a port tree (numpy, PyTorch
# layouts), the inverse of the importers' key maps; the DAC and quantizer
# convolutions weight-normed (weight_g / weight_v, or torch >= 2.1's
# parametrizations), as the published checkpoints store them
# ---------------------------------------------------------------------------


def _lin(sd, k, p):
    sd[f"{k}.weight"] = np.ascontiguousarray(p["w"].T)
    if "b" in p:
        sd[f"{k}.bias"] = p["b"]


def _conv(sd, k, p, wn=None):
    w = p["w"]
    if wn is None:
        sd[f"{k}.weight"] = w
    else:
        norm = np.sqrt((w.astype(np.float64) ** 2).sum(axis=(1, 2), keepdims=True))
        g, v = norm.astype(np.float32), 2.0 * w
        names = (("weight_g", "weight_v") if wn == "g_v" else
                 ("parametrizations.weight.original0", "parametrizations.weight.original1"))
        sd[f"{k}.{names[0]}"], sd[f"{k}.{names[1]}"] = g, v
    if "b" in p:
        sd[f"{k}.bias"] = p["b"]


def _ln(sd, k, p):
    sd[f"{k}.weight"], sd[f"{k}.bias"] = p["g"], p["b"]


def _tf_layers(sd, b, layers):
    for i, p in enumerate(layers):
        k = f"{b}.layers.{i}"
        _ln(sd, f"{k}.self_attn_layer_norm", p["attn_ln"])
        for n, ref in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("out", "out_proj")):
            _lin(sd, f"{k}.self_attn.{ref}", p[n])
        _ln(sd, f"{k}.final_layer_norm", p["final_ln"])
        _lin(sd, f"{k}.fc1", p["fc1"])
        _lin(sd, f"{k}.fc2", p["fc2"])


def _xy_sd(t):
    sd = {}
    for name in ("semantic_encoder", "acoustic_encoder"):
        p = t[name]
        _conv(sd, f"{name}.conv1", p["conv1"])
        _conv(sd, f"{name}.conv2", p["conv2"])
        _tf_layers(sd, name, p["layers"])
        _ln(sd, f"{name}.layer_norm", p["ln"])
    for name, ref in (("semantic_adapter", "semantic_encoder_adapter"),
                      ("pre_rvq_adapter", "pre_rvq_adapter"),
                      ("post_rvq_adapter", "post_rvq_adapter")):
        p = t[name]
        _tf_layers(sd, ref, p["layers"])
        _ln(sd, f"{ref}.layer_norm", p["ln"])
        for opt in ("proj", "out_proj"):
            if opt in p:
                _lin(sd, f"{ref}.{opt}", p[opt])
    d = t["downsample"]
    _conv(sd, "downsample.gate_proj", d["gate"])
    _conv(sd, "downsample.up_proj", d["up"])
    _lin(sd, "downsample.down_proj", d["down"])
    _ln(sd, "downsample.layer_norm", d["ln"])
    q = t["quantizer"]
    one_by_one = lambda p: {"w": np.ascontiguousarray(p["w"].T[..., None]), "b": p["b"]}
    _conv(sd, "quantizer.input_proj", one_by_one(q["input_proj"]), wn="g_v")
    _conv(sd, "quantizer.output_proj", one_by_one(q["output_proj"]), wn="param")
    for i, qi in enumerate(q["quantizers"]):
        sd[f"quantizer.quantizers.{i}.codebook"] = qi["codebook"]
        sd[f"quantizer.quantizers.{i}.cluster_size"] = np.ones(len(qi["codebook"]), np.float32)
        _conv(sd, f"quantizer.quantizers.{i}.in_project", one_by_one(qi["in_project"]), wn="g_v")
        _conv(sd, f"quantizer.quantizers.{i}.out_project", one_by_one(qi["out_project"]),
              wn="g_v")
    _conv(sd, "upsample.up_conv", t["upsample"]["up"])
    a = t["acoustic_decoder"]
    _tf_layers(sd, "acoustic_decoder", a["layers"])
    _ln(sd, "acoustic_decoder.layer_norm", a["ln"])
    _conv(sd, "acoustic_decoder.deconv1", a["deconv1"])
    _conv(sd, "acoustic_decoder.deconv2", a["deconv2"])
    v, vb = t["vocos"], "enhanced_vocos.backbone"
    _conv(sd, f"{vb}.embed", v["backbone"]["embed"])
    _ln(sd, f"{vb}.norm", v["backbone"]["norm"])
    for i, blk in enumerate(v["backbone"]["blocks"]):
        _conv(sd, f"{vb}.convnext.{i}.dwconv", blk["dwconv"])
        _ln(sd, f"{vb}.convnext.{i}.norm", blk["norm"])
        _lin(sd, f"{vb}.convnext.{i}.pwconv1", blk["pw1"])
        _lin(sd, f"{vb}.convnext.{i}.pwconv2", blk["pw2"])
        sd[f"{vb}.convnext.{i}.gamma"] = blk["gamma"]
    _ln(sd, f"{vb}.final_layer_norm", v["backbone"]["final_ln"])
    _lin(sd, "enhanced_vocos.head.out", v["head"])
    sd["semantic_encoder.positional_embedding"] = np.zeros((4, 32), np.float32)  # dropped
    return sd


def _higgs_sd(t):
    sd = {}
    snake = lambda k, p: sd.__setitem__(f"{k}.alpha", p["alpha"].reshape(1, -1, 1))

    def res(k, p):
        snake(f"{k}.block.0", p["snake1"])
        _conv(sd, f"{k}.block.1", p["conv1"], wn="g_v")
        snake(f"{k}.block.2", p["snake2"])
        _conv(sd, f"{k}.block.3", p["conv2"], wn="param")

    e = t["encoder"]
    _conv(sd, "encoder.block.0", e["conv_in"], wn="g_v")
    for i, blk in enumerate(e["blocks"]):
        for j, r in enumerate(blk["res"]):
            res(f"encoder.block.{i + 1}.block.{j}", r)
        snake(f"encoder.block.{i + 1}.block.3", blk["snake"])
        _conv(sd, f"encoder.block.{i + 1}.block.4", blk["conv"], wn="g_v")
    n = len(e["blocks"])
    snake(f"encoder.block.{n + 1}", e["snake_out"])
    _conv(sd, f"encoder.block.{n + 2}", e["conv_out"], wn="g_v")
    s = t["encoder_semantic"]
    _conv(sd, "encoder_semantic.conv.conv", s["conv_in"])
    for i, blk in enumerate(s["blocks"]):
        for j, r in enumerate(blk["res"]):
            _conv(sd, f"encoder_semantic.conv_blocks.{i}.res_units.{j}.conv1.conv", r["conv1"])
            _conv(sd, f"encoder_semantic.conv_blocks.{i}.res_units.{j}.conv2", r["conv2"])
        _conv(sd, f"encoder_semantic.conv_blocks.{i}.conv.conv", blk["conv"])
    for name in ("fc_prior", "fc_post2", "fc_post1"):
        _lin(sd, name, t[name])
    for i, cb in enumerate(t["quantizer"]["codebooks"]):
        sd[f"quantizer.vq.layers.{i}._codebook.embed"] = cb
        sd[f"quantizer.vq.layers.{i}._codebook.embed_avg"] = cb  # dropped
    d = t["decoder_2"]
    _conv(sd, "decoder_2.model.0", d["conv_in"], wn="g_v")
    for i, blk in enumerate(d["blocks"]):
        snake(f"decoder_2.model.{i + 1}.block.0", blk["snake"])
        _conv(sd, f"decoder_2.model.{i + 1}.block.1", blk["up"], wn="g_v")
        for j, r in enumerate(blk["res"]):
            res(f"decoder_2.model.{i + 1}.block.{2 + j}", r)
    snake(f"decoder_2.model.{n + 1}", d["snake_out"])
    _conv(sd, f"decoder_2.model.{n + 2}", d["conv_out"], wn="g_v")
    return sd


def _numpy_tree(tree):
    return rwkv7.tree_map(bridge.to_numpy, tree)


def test_xy_tokenizer_matches_jax(jit_jax_codecs, tmp_path):
    """Named checks: decode and decode_long (4 windows) within 1e-4 of JAX;
    encode of 2 s and encode_long of 7 s (4 windows) give JAX's codes;
    the importer on a synthetic checkpoint gives the JAX importer's tree
    (through the bridge), also from a file with the training wrapper's
    'generator.' prefix."""
    jcfg, tcfg = jxt.XYTokenizerConfig(**XY_SMALL), xt.XYTokenizerConfig(**XY_SMALL)
    jp = _jax_tree(jxt.init_params, jcfg, 9)
    tp = bridge.xy_tokenizer_params_from_numpy(jax.tree.map(np.asarray, jp))
    codes = np.random.default_rng(1).integers(0, 16, (8, 1, 20))
    with nn.f32():
        wav = xt.decode(tp, tcfg, torch.from_numpy(codes))
    want = np.asarray(jxt.decode(jp, jcfg, jnp.asarray(codes)))
    assert wav.shape == (1, 20 * 8 * 16)
    assert _rel(wav.numpy(), want) <= 1e-4

    long_codes = np.random.default_rng(2).integers(0, 16, (8, 80))
    wav_l = xt.decode_long(tp, tcfg, long_codes, **LONG)
    want_l = jxt.decode_long(jp, jcfg, long_codes, **LONG)
    assert wav_l.shape == want_l.shape == (80 * 8 * 16,)
    assert _rel(wav_l, want_l) <= 1e-4

    clip = _clip(2.0)
    mel = xt.whisper_log_mel(torch.from_numpy(clip[None]), n_mels=16)
    jmel = jxt.whisper_log_mel(jnp.asarray(clip[None]), n_mels=16)
    got = xt.encode(tp, tcfg, mel).numpy()
    np.testing.assert_array_equal(got, np.asarray(jxt.encode(jp, jcfg, jmel)))
    assert got.shape == (8, 1, 25)
    long_clip = _clip(7.0, seed=3)
    got_l = xt.encode_long(tp, tcfg, long_clip, **LONG)
    np.testing.assert_array_equal(got_l, jxt.encode_long(jp, jcfg, long_clip, **LONG))
    assert got_l.shape == (8, 7 * 16000 // 1280)

    ref = _numpy_tree(xt.init_params(torch.Generator().manual_seed(4), tcfg))
    sd = _xy_sd(ref)
    imported = xy_import.xy_from_state_dict(sd, tcfg)
    _same_trees(imported, bridge.xy_tokenizer_params_from_numpy(
        jxy_import.xy_from_state_dict(sd, jcfg)))
    _same_trees(imported, ref, rtol=1e-6)  # the weight norms folded back
    path = str(tmp_path / "xy.safetensors")
    export_hf.save_safetensors({**{f"generator.{k}": v for k, v in sd.items()},
                                "discriminator.w": np.zeros(3, np.float32)}, path)
    _same_trees(xy_import.load_xy_tokenizer(path, tcfg), imported)


def test_higgs_matches_jax(jit_jax_codecs, tmp_path, monkeypatch):
    """Named checks: Higgs decode within 1e-4 of JAX and encode's codes
    equal; the importer on a synthetic checkpoint gives the JAX importer's
    tree (through the bridge); the HuBERT teacher of a tiny random model
    saved to disk within 1e-5 of the JAX module's."""
    jcfg, tcfg = jhiggs.HiggsConfig(**HIGGS_SMALL), higgs.HiggsConfig(**HIGGS_SMALL)
    jp = _jax_tree(jhiggs.init_params, jcfg, 11)
    tp = bridge.higgs_params_from_numpy(jax.tree.map(np.asarray, jp))
    codes = np.random.default_rng(5).integers(0, 16, (8, 2, 24))
    with nn.f32():
        wav = higgs.decode(tp, tcfg, torch.from_numpy(codes))
    want = np.asarray(jhiggs.decode(jp, jcfg, jnp.asarray(codes)))
    assert wav.shape == (2, 24 * tcfg.hop_length)
    assert _rel(wav.numpy(), want) <= 1e-4

    clip = np.stack([_clip(0.1, seed=6), _clip(0.1, seed=7)])  # 1600 samples, 200 frames
    feats = np.random.default_rng(8).standard_normal((2, 200, 16)).astype(np.float32)
    got = higgs.encode(tp, tcfg, torch.from_numpy(clip), torch.from_numpy(feats)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jhiggs.encode(jp, jcfg, jnp.asarray(clip),
                                                               jnp.asarray(feats))))
    assert got.shape == (8, 2, 200)

    ref = _numpy_tree(higgs.init_params(torch.Generator().manual_seed(12), tcfg))
    sd = _higgs_sd(ref)
    imported = higgs_import.higgs_from_state_dict(sd, tcfg)
    _same_trees(imported, bridge.higgs_params_from_numpy(
        jhiggs_import.higgs_from_state_dict(sd, jcfg)))
    _same_trees(imported, ref, rtol=1e-6)  # the weight norms folded back
    path = str(tmp_path / "higgs.safetensors")
    export_hf.save_safetensors(sd, path)
    _same_trees(higgs_import.load_higgs(path, tcfg), imported)

    monkeypatch.setenv("USE_TF", "0")  # no TensorFlow import under transformers (seconds)
    from transformers import HubertConfig, HubertModel

    torch.manual_seed(0)
    HubertModel(HubertConfig(hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
                             intermediate_size=32, conv_dim=(8,) * 7,
                             num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=2)
                ).save_pretrained(tmp_path / "hubert")
    wavs = np.stack([_clip(0.5, seed=9), _clip(0.5, seed=10)])
    feats_t = higgs.hubert_feature_fn(str(tmp_path / "hubert"), device="cpu")(wavs)
    feats_j = jhiggs.hubert_feature_fn(str(tmp_path / "hubert"))(wavs)
    assert feats_t.shape == feats_j.shape and feats_j.shape[::2] == (2, 16)
    assert _rel(feats_t.numpy(), feats_j) <= 1e-5


class FakeTok:
    def encode(self, text):
        return [ord(c) % 200 + 1 for c in text][:10]


@pytest.mark.parametrize("kind", ["xy", "higgs"])
def test_xy_pipeline_matches_jax(jit_jax_codecs, kind):
    """XYPipeline.synthesize, an 8-channel LM 32 x 2 (head 8, speech
    vocabulary 16 = the codebooks) with the small codec of `kind`, fed the
    JAX pipeline's draws for its seed: JAX's codes up to the flush (JAX
    keeps flush frames after them, a fault of the reference), the wav
    within 1e-4 of the JAX codec's on those codes, and the codec's own
    sample rate (the JAX pipeline reports the one it was given)."""
    vocab = dict(text_vocab_size=300, speech_vocab_size=16, text_shift_size=256)
    jcfg = dataclasses.replace(jxy.default_config(
        hidden_size=32, num_layers=2, head_size=8, gate_lora=8, wkv_chunk=16, remat=False,
        dtype=jnp.float32), **vocab)
    tcfg = dataclasses.replace(xy.default_config(
        hidden_size=32, num_layers=2, head_size=8, gate_lora=8, dtype=torch.float32), **vocab)
    # the LM: the port's init (the trees match name for name), heads x 4 so
    # that the flush comes within 32 steps
    tp = xy.init_params(torch.Generator().manual_seed(2), tcfg)
    tp["heads"] = {k: 4.0 * v for k, v in tp["heads"].items()}
    jp = jax.tree.map(jnp.asarray, bridge.params_to_numpy(tp))
    if kind == "xy":
        jccfg, tccfg = jxt.XYTokenizerConfig(**XY_SMALL), xt.XYTokenizerConfig(**XY_SMALL)
        jcp = _jax_tree(jxt.init_params, jccfg, 3)
        tcp = bridge.xy_tokenizer_params_from_numpy(jax.tree.map(np.asarray, jcp))
    else:
        jccfg, tccfg = jhiggs.HiggsConfig(**HIGGS_SMALL), higgs.HiggsConfig(**HIGGS_SMALL)
        jcp = _jax_tree(jhiggs.init_params, jccfg, 3)
        tcp = bridge.higgs_params_from_numpy(jax.tree.map(np.asarray, jcp))
    jpipe = JXYPipeline(jcfg, jp, FakeTok(), codec_cfg=jccfg, codec_params=jcp, codec_kind=kind)
    tpipe = XYPipeline(tcfg, tp, FakeTok(), codec_cfg=tccfg, codec_params=tcp, codec_kind=kind,
                       device="cpu")
    steps, seed = 32, 5
    want = jpipe.synthesize("hello", max_new_tokens=steps, seed=seed)
    noise = [torch.tensor(np.asarray(n))
             for n in _jax_draws(jax.random.PRNGKey(seed), steps, 1, (300,) + (16,) * 7)]
    got = tpipe.synthesize("hello", max_new_tokens=steps, noise=noise)
    T = got.codes.shape[1]
    assert 0 < T < steps - 7  # the flush ended the audio early
    # JAX cuts at n_audio, which counts audio draws of the countdown too:
    # its codes are the port's, then flush frames (channel 0 the EOS, 299)
    np.testing.assert_array_equal(want.codes[:, :T], got.codes)
    assert (want.codes[0, T:] == 299 - 256).all()
    jdecode = jxt.decode if kind == "xy" else jhiggs.decode
    ref = np.asarray(jdecode(jcp, jccfg, jnp.asarray(got.codes)[:, None]))[0]
    assert got.wav.shape == ref.shape == (T * (8 * 16 if kind == "xy" else tccfg.hop_length),)
    assert _rel(got.wav, ref) <= 1e-4
    assert got.sample_rate == (24000 if kind == "xy" else 16000) and want.sample_rate == 24000
    assert got.llm_s > 0 and got.codec_s > 0
    if kind == "xy":  # the published LM's tokens: the added ones after the world vocabulary
        ids = xy_text_tokenizer().encode("[S3]hi[CTL1][SP7]")
        assert ids[0] == 65536 + 1024 + 3 and ids[-2:] == [65536 + 1034 + 1, 65536 + 7]
