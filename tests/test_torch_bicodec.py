"""BiCodec, its blocks, the mel, the quantizers and the wav2vec2 frontend:
the port (rwkvtts_torch/codecs) against the JAX package on one set of
weights carried through rwkvtts_torch.bridge, the committed golden
tests/goldens/bicodec.npz replayed through the port's importer, and the
tokenizer read from a model directory."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden_configs as gc
from rwkvtts_tpu.codecs import bicodec as jb
from rwkvtts_tpu.codecs import dsp as jdsp
from rwkvtts_tpu.codecs import nn as jnn
from rwkvtts_tpu.codecs import quantizers as jq
from rwkvtts_tpu.codecs import spark_tokenizer as jst
from rwkvtts_tpu.codecs import torch_import as jti
from rwkvtts_torch import bridge
from rwkvtts_torch.codecs import bicodec as tb
from rwkvtts_torch.codecs import dsp as tdsp
from rwkvtts_torch.codecs import nn as tnn
from rwkvtts_torch.codecs import quantizers as tq
from rwkvtts_torch.codecs import spark_tokenizer as tst
from rwkvtts_torch.codecs import torch_import as tti
from rwkvtts_torch.utils import fixtures

torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _np(x, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(x)).astype(np.float32)


def port_config(jcfg):
    """A JAX BiCodec config (or one of its parts) -> the port's."""
    kw = {}
    for f in dataclasses.fields(jcfg):
        v = getattr(jcfg, f.name)
        kw[f.name] = port_config(v) if dataclasses.is_dataclass(v) else v
    return getattr(tb, type(jcfg).__name__)(**kw)


def small_config():
    """tests/test_bicodec.py's small config: every stack at ratio 1."""
    return jb.BiCodecConfig(
        mel=jb.MelParams(n_fft=256, win_length=160, hop_length=80, num_mels=32),
        encoder=jb.VocosStackConfig(24, 32, 64, 2, 16, sample_ratios=(1, 1)),
        quantizer_codebook_size=64, quantizer_codebook_dim=8, quantizer_input_dim=16,
        prenet=jb.VocosStackConfig(16, 32, 64, 2, 16, condition_dim=16, sample_ratios=(1, 1)),
        postnet=jb.VocosStackConfig(16, 32, 64, 2, 32),
        wave=jb.WaveGeneratorConfig(input_channel=16, channels=32, rates=(4, 2),
                                    kernel_sizes=(8, 4)),
        speaker=jb.SpeakerEncoderConfig(input_dim=32, out_dim=16, latent_dim=16, token_num=4,
                                        fsq_levels=(4, 4, 4, 4, 4, 4), ecapa_channels=64),
    )


def _leaf(path, shape, rng):
    """Seeded values for a leaf of the JAX tree: norm gains and snake
    alphas near 1, batch-norm variances in [0.5, 2], the rest small normals
    (the golden fixtures' recipe)."""
    name = getattr(path[-1], "key", None)
    if name == "var":
        return rng.uniform(0.5, 2.0, shape).astype(np.float32)
    scale, shift = (0.1, 1.0) if name in ("g", "alpha", "gamma") else (0.1, 0.0)
    return (shift + scale * rng.standard_normal(shape)).astype(np.float32)


def _both(init, *args, seed=0):
    """A JAX parameter tree of `init`'s shapes filled from `seed`, and the
    port's copy of it through the bridge."""
    shapes = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), *args))
    rng = np.random.default_rng(seed)
    jp = jax.tree_util.tree_map_with_path(lambda p, s: _leaf(p, s.shape, rng), shapes)
    return jax.tree.map(jnp.asarray, jp), bridge.bicodec_params_from_numpy(jp)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

_X = (2, 12, 16)


def _case(name):
    """(JAX fn, port fn, JAX params, port params, inputs) of one block."""
    x, cond = _np(_X, 1), _np((2, 8), 2)
    if name == "batch_norm":
        jp, tp = _both(lambda k: jnn.batch_norm_init(16))
        return jnn.batch_norm, tnn.batch_norm, jp, tp, (x,)
    if name == "rms_norm_l2":
        jp, tp = _both(lambda k: jnn.rms_norm_init(16))
        return jnn.rms_norm_l2, tnn.rms_norm_l2, jp, tp, (x,)
    if name == "ada_layer_norm":
        jp, tp = _both(jnn.ada_layer_norm_init, 8, 16)
        return jnn.ada_layer_norm, tnn.ada_layer_norm, jp, tp, (x, cond)
    if name == "convnext_block":
        jp, tp = _both(jnn.convnext_block_init, 16, 40, 0.5)
        return jnn.convnext_block, tnn.convnext_block, jp, tp, (x,)
    if name == "vocos_backbone_cond":
        jp, tp = _both(lambda k: jnn.vocos_backbone_init(k, 16, 24, 40, 2, cond_dim=8))
        return jnn.vocos_backbone, tnn.vocos_backbone, jp, tp, (x, cond)
    if name.startswith("sampling_"):  # sampling_up3, sampling_down2, sampling_1
        kind, r = name.split("_")[1][:-1], int(name[-1])
        up = r if kind == "up" else 1
        down = r if kind == "down" else 1
        jp, tp = _both(lambda k: jnn.sampling_block_init(k, 16, groups=16, upsample_scale=up,
                                                         downsample_scale=down))
        return (lambda p, x: jnn.sampling_block(p, x, 16, 16, up, down),
                lambda p, x: tnn.sampling_block(p, x, 16, up, down), jp, tp, (x,))
    if name == "attention_include_queries":
        jp, tp = _both(lambda k: jnn.attention_init(k, 16, heads=2, dim_head=8))
        ctx = _np((2, 7, 16), 4)
        return (lambda p, x, c: jnn.attention(p, x, c, heads=2, include_queries=True),
                lambda p, x, c: tnn.attention(p, x, c, heads=2, include_queries=True),
                jp, tp, (x, ctx))
    if name == "geglu_ff":
        jp, tp = _both(jnn.geglu_ff_init, 16)
        return jnn.geglu_ff, tnn.geglu_ff, jp, tp, (x,)
    if name == "perceiver_resampler":
        jp, tp = _both(lambda k: jnn.perceiver_resampler_init(k, 16, 24, num_latents=4,
                                                              heads=2, dim_head=8))
        ctx = _np((2, 9, 24), 4)
        return (lambda p, c: jnn.perceiver_resampler(p, c, heads=2),
                lambda p, c: tnn.perceiver_resampler(p, c, heads=2), jp, tp, (ctx,))
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "batch_norm", "rms_norm_l2", "ada_layer_norm", "convnext_block", "vocos_backbone_cond",
    "sampling_up2", "sampling_up3", "sampling_down2", "sampling_down3", "sampling_1",
    "attention_include_queries", "geglu_ff", "perceiver_resampler"])
def test_block_matches_jax(name):
    """Each new codecs/nn block at <= 1e-5 relative; a scale-1 sampling
    block triples its input, an up block of odd scale keeps T x scale."""
    jfn, tfn, jp, tp, xs = _case(name)
    want = np.asarray(jax.jit(jfn)(jp, *xs))
    got = tfn(tp, *(torch.from_numpy(x) for x in xs)).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-5
    if name == "sampling_1":
        np.testing.assert_allclose(got, 3 * xs[0], rtol=1e-6)
    if name == "sampling_up3":
        assert got.shape[1] == 3 * _X[1]


# ---------------------------------------------------------------------------
# mel and quantizers
# ---------------------------------------------------------------------------


def test_mel_matches_jax():
    """BiCodec's mel (16 kHz, n_fft 1024, window 640, hop 320, 128 slaney
    bins from 10 Hz, power 1) at <= 1e-5 relative; HiFT's STFT (window =
    n_fft) unchanged."""
    m = tb.MelParams()
    wav = _np((2, 8000), 5, 0.3)
    want = jdsp.mel_spectrogram(jnp.asarray(wav), m.sample_rate, m.n_fft, m.win_length,
                                m.hop_length, m.num_mels, m.mel_fmin, m.mel_fmax)
    got = tdsp.mel_spectrogram(torch.from_numpy(wav), m.sample_rate, m.n_fft, m.win_length,
                               m.hop_length, m.num_mels, m.mel_fmin, m.mel_fmax)
    assert got.shape == (2, 8000 // 320 + 1, 128)
    assert _rel(got.numpy(), want) <= 1e-5
    np.testing.assert_array_equal(tdsp.mel_filterbank(16000, 1024, 128, 10.0),
                                  jdsp.mel_filterbank(16000, 1024, 128, 10.0))
    re_j, _ = jdsp.stft(jnp.asarray(wav), 16, 4)
    re_t, _ = tdsp.stft(torch.from_numpy(wav), 16, 4)
    assert _rel(re_t.numpy(), re_j) <= 1e-5


def test_quantizers_match_jax():
    """FVQ, FSQ and residual FSQ: indices exactly equal, the vectors
    decoded from them at <= 1e-6; the FVQ training forward's losses."""
    jp, tp = _both(jq.factorized_vq_init, 24, 64, 8)
    z = _np((2, 30, 24), 6)
    idx_j = np.asarray(jax.jit(jq.factorized_vq_tokenize)(jp, z))
    idx_t = tq.factorized_vq_tokenize(tp, torch.from_numpy(z))
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)
    assert _rel(tq.factorized_vq_detokenize(tp, idx_t).numpy(),
                jax.jit(jq.factorized_vq_detokenize)(jp, idx_j)) <= 1e-6
    fj = jax.jit(jq.factorized_vq_forward)(jp, z)
    ft = tq.factorized_vq_forward(tp, torch.from_numpy(z))
    for k in ("z_q", "vq_loss", "perplexity", "active_num"):
        assert _rel(ft[k].detach().numpy(), fj[k]) <= 1e-5, k

    levels = (4, 4, 4, 4, 4, 4)
    h = _np((3, 40, 6), 7, 2.0)
    cj, ij = jax.jit(lambda h: jq.fsq_forward(h, levels))(h)
    ct, it = tq.fsq_forward(torch.from_numpy(h), levels)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(
        tq.fsq_indices_to_codes(it, levels).numpy(),
        np.asarray(jax.jit(lambda i: jq.fsq_indices_to_codes(i, levels))(ij)))

    jp, tp = _both(jq.residual_fsq_init, 16, levels)
    x = _np((2, 5, 16), 8)
    oj, rj = jax.jit(lambda p, x: jq.residual_fsq_forward(p, x, levels))(jp, x)
    ot, rt = tq.residual_fsq_forward(tp, torch.from_numpy(x), levels)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    assert _rel(ot.numpy(), oj) <= 1e-6
    back = jax.jit(lambda p, r: jq.residual_fsq_output_from_indices(p, r, levels))(jp, rj)
    assert _rel(tq.residual_fsq_output_from_indices(tp, rt, levels).numpy(), back) <= 1e-6


# ---------------------------------------------------------------------------
# BiCodec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["small", "golden"])
def test_bicodec_matches_jax(which):
    """tokenize and detokenize on one set of seeded weights: tokens equal,
    the wav at <= 1e-4 relative, T x prod(rates) samples."""
    jcfg = small_config() if which == "small" else gc.bicodec_config()
    cfg = port_config(jcfg)
    jp, tp = _both(lambda k: jb.init_params(k, jcfg))
    feat = _np((2, 16, cfg.encoder.input_channels), 9)
    ref = _np((2, 4000), 10, 0.3)
    sem_j, glob_j = jax.jit(lambda p, f, r: jb.tokenize(p, jcfg, f, r))(jp, feat, ref)
    sem_t, glob_t = tb.tokenize(tp, cfg, torch.from_numpy(feat), torch.from_numpy(ref))
    np.testing.assert_array_equal(sem_t.numpy(), np.asarray(sem_j))
    np.testing.assert_array_equal(glob_t.numpy(), np.asarray(glob_j))
    # detokenize from spread tokens (a random init's tokenize collapses)
    rng = np.random.default_rng(11)
    sem = rng.integers(0, cfg.quantizer_codebook_size, (2, 10))
    glob = rng.integers(0, 4096, (2, 1, cfg.speaker.token_num))
    want = np.asarray(jax.jit(lambda p, s, g: jb.detokenize(p, jcfg, s, g))(jp, sem, glob))
    got = tb.detokenize(tp, cfg, torch.from_numpy(sem), torch.from_numpy(glob)).numpy()
    hop = int(np.prod(cfg.wave.rates)) * int(np.prod(cfg.prenet.sample_ratios))
    assert got.shape == want.shape == (2, 10 * hop)
    assert _rel(got, want) <= 1e-4


@pytest.fixture(scope="module")
def golden():
    return fixtures.load_golden(f"{gc.GOLDEN_DIR}/bicodec.npz")


def test_golden_replays_through_the_port_importer(golden):
    """tests/goldens/bicodec.npz (the reference's torch BiCodec at the
    reduced config) through torch_import: mel atol 2e-4, tokens exact, wav
    atol 2e-3, the JAX package's own gates (tests/test_goldens.py); the
    tree equals the JAX importer's, bridged."""
    sd, io = golden
    cfg = port_config(gc.bicodec_config())
    p = tti.bicodec_from_state_dict(sd, cfg)
    want = bridge.bicodec_params_from_numpy(jti.bicodec_from_state_dict(sd, gc.bicodec_config()))
    for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    ref = torch.from_numpy(io["ref_wav"])
    np.testing.assert_allclose(tb.ref_mel(cfg, ref).numpy(), io["mel"].transpose(0, 2, 1),
                               atol=2e-4)
    sem, glob = tb.tokenize(p, cfg, torch.from_numpy(io["feat"]), ref)
    np.testing.assert_array_equal(sem.numpy(), io["semantic"])
    np.testing.assert_array_equal(glob.numpy().reshape(io["global_tokens"].shape),
                                  io["global_tokens"])
    wav = tb.detokenize(p, cfg, sem, glob)
    np.testing.assert_allclose(wav.numpy(), io["wav"][:, 0], atol=2e-3)


def _tiny_wav2vec2(hidden: int):
    """A 16-layer wav2vec2 of xlsr-53's kind (layer-norm feature encoder,
    stable layer norm, conv bias), narrow and with two conv layers."""
    from transformers import Wav2Vec2Config

    return Wav2Vec2Config(
        hidden_size=hidden, num_hidden_layers=16, num_attention_heads=2,
        intermediate_size=2 * hidden, conv_dim=(8, 8), conv_kernel=(10, 3), conv_stride=(5, 2),
        feat_extract_norm="layer", do_stable_layer_norm=True, conv_bias=True,
        num_conv_pos_embeddings=8, num_conv_pos_embedding_groups=2)


def test_wav2vec2_frontend_matches_flax(tmp_path):
    """The PyTorch frontend against the JAX package's Flax one on the same
    saved weights: the normalised wav, the mean of hidden states 11, 14
    and 16 (16 is the last, after the encoder's final norm), <= 1e-4
    relative. The Flax side is _FlaxWav2Vec2Frontend's model and
    normalisation; its own __call__ reads `.hidden_states` off the tuple
    that this transformers' Flax module returns without return_dict."""
    fe = tst.Wav2Vec2Frontend.from_config(_tiny_wav2vec2(16), seed=0, device="cpu")
    fe.model.save_pretrained(tmp_path)
    wav = _np((1, 4000), 12, 0.3)
    got = tst.Wav2Vec2Frontend.from_pretrained(tmp_path, device="cpu")(wav).numpy()
    flax = jst._FlaxWav2Vec2Frontend(str(tmp_path))
    x = wav - wav.mean(-1, keepdims=True)
    x = x / np.sqrt(x.var(-1, keepdims=True) + 1e-7)
    hs = jax.jit(lambda p, x: flax.model(x, params=p, output_hidden_states=True).hidden_states)(
        flax.model.params, x)
    want = np.asarray((hs[11] + hs[14] + hs[16]) / 3)
    assert got.shape == want.shape == (1, 399, 16)
    assert _rel(got, want) <= 1e-4


def write_model_dir(path, sd, jcfg):
    """A Spark-TTS model directory's BiCodec half: model.safetensors of the
    state dict `sd` and the config.yaml of the JAX config `jcfg`."""
    import yaml
    from safetensors.numpy import save_file

    (path / "BiCodec").mkdir(parents=True)
    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()},
              str(path / "BiCodec" / "model.safetensors"))
    stack = lambda s: {"input_channels": s.input_channels, "vocos_dim": s.vocos_dim,
                       "vocos_intermediate_dim": s.vocos_intermediate_dim,
                       "vocos_num_layers": s.vocos_num_layers,
                       "out_channels": s.out_channels, "sample_ratios": list(s.sample_ratios),
                       "condition_dim": s.condition_dim}
    w, s = jcfg.wave, jcfg.speaker
    with open(path / "BiCodec" / "config.yaml", "w") as f:
        yaml.safe_dump({"audio_tokenizer": {
            "mel_params": dataclasses.asdict(jcfg.mel),
            "encoder": stack(jcfg.encoder), "prenet": stack(jcfg.prenet),
            "postnet": stack(jcfg.postnet),
            "quantizer": {"codebook_size": jcfg.quantizer_codebook_size,
                          "codebook_dim": jcfg.quantizer_codebook_dim,
                          "input_dim": jcfg.quantizer_input_dim},
            "decoder": {"input_channel": w.input_channel, "channels": w.channels,
                        "rates": list(w.rates), "kernel_sizes": list(w.kernel_sizes)},
            "speaker_encoder": {"input_dim": s.input_dim, "out_dim": s.out_dim,
                                "latent_dim": s.latent_dim, "token_num": s.token_num,
                                "fsq_levels": list(s.fsq_levels),
                                "fsq_num_quantizers": s.fsq_num_quantizers}}}, f)
    return path


def test_from_pretrained_reads_a_model_dir(golden, tmp_path):
    """A Spark-TTS model directory (BiCodec/model.safetensors from the
    golden state dict, a config.yaml of the reduced config, a wav2vec2
    dir): the config parses back as the JAX reader parses it, detokenize
    gives the golden wav, and tokenize runs the frontend into the codec."""
    sd, io = golden
    jcfg = gc.bicodec_config()
    write_model_dir(tmp_path, sd, jcfg)
    tst.Wav2Vec2Frontend.from_config(_tiny_wav2vec2(12), device="cpu").model.save_pretrained(
        tmp_path / "wav2vec2-large-xlsr-53")

    codec = tst.SparkAudioTokenizer.from_pretrained(tmp_path, device="cpu")
    assert codec.cfg == port_config(jcfg)
    assert codec.cfg == port_config(
        jst.bicodec_config_from_yaml(tmp_path / "BiCodec" / "config.yaml"))
    wav = codec.detokenize(io["global_tokens"], io["semantic"])
    np.testing.assert_allclose(wav, io["wav"][:, 0], atol=2e-3)
    rows = codec.detokenize_rows(io["global_tokens"], io["semantic"], [4])
    np.testing.assert_array_equal(rows[0], wav[0])
    glob, sem = codec.tokenize(_np((3000,), 13, 0.3))
    assert glob.shape == (1, 1, 4) and sem.shape[0] == 1 and sem.shape[1] > 0
    assert ((sem >= 0) & (sem < jcfg.quantizer_codebook_size)).all()
