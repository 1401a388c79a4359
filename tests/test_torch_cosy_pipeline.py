"""The Cosy zero-shot pipeline, port vs JAX package, on the CPU:
cosy_generate on both decode routes given the JAX package's noise (the
model's decode step against JAX's XLA step; the B=1 whole-step route
against JAX's B=1 kernel in interpret mode), cosy_generate_mega_b64's
plain route against JAX's B=64 kernel in interpret mode, the prompts of
the cross-lingual and instruct modes, the choice of decode route, voice
conversion without the LM, the speed resize against jax.image.resize, and
the refusals. Same weights through the bridge; the
pipelines of `pipes` also serve tests/test_torch_cosy_zero_shot.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkvtts_tpu.codecs import campplus as jcp
from rwkvtts_tpu.codecs import conformer as jconformer
from rwkvtts_tpu.codecs import flow as jflow
from rwkvtts_tpu.codecs import hift as jhift
from rwkvtts_tpu.codecs import s3_tokenizer as js3
from rwkvtts_tpu.infer import generate as jgen
from rwkvtts_tpu.infer.cosy_pipeline import CosyPipeline as JCosyPipeline
from rwkvtts_tpu.models import cosy as jcosy
from rwkvtts_tpu.models import rwkv7 as jrwkv7
from rwkvtts_tpu.ops import decode_mega as jdm
from rwkvtts_tpu.ops import decode_mega_b64 as jdmb
from rwkvtts_torch import bridge
from rwkvtts_torch.codecs import campplus as cp
from rwkvtts_torch.codecs import conformer, dsp, flow, hift
from rwkvtts_torch.codecs import s3_tokenizer as s3
from rwkvtts_torch.infer import generate as tgen
from rwkvtts_torch.infer import streaming
from rwkvtts_torch.infer.cosy_pipeline import CosyPipeline
from rwkvtts_torch.models import cosy, rwkv7
from rwkvtts_torch.ops import decode_mega as dm
from rwkvtts_torch.ops import decode_mega_b64 as dmb

torch.set_num_threads(2)

EOS, V, K = 6561, 6562, 25
# the tiny flow / HiFT of tests/test_torch_cosy_stream.py, S3 and CAM++ small
ENC = dict(input_size=24, output_size=24, attention_heads=2, linear_units=48, num_blocks=1,
           num_up_blocks=1)
EST = dict(in_channels=16 * 4, out_channels=16, channels=(16,), n_blocks=1, num_mid_blocks=1,
           num_heads=2, attention_head_dim=8, static_chunk_size=2)
FLOW = dict(input_size=24, output_size=16, spk_embed_dim=24, vocab_size=6562, n_timesteps=2)
HIFT = dict(in_channels=16, base_channels=32, nb_harmonics=2, upsample_rates=(4, 3),
            upsample_kernel_sizes=(8, 7), istft_n_fft=16, istft_hop_len=4,
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),),
            source_resblock_kernel_sizes=(7, 7),
            source_resblock_dilation_sizes=((1, 2), (1, 2)), f0_cond_channels=16)
S3_SMALL = dict(n_mels=128, d_model=32, layers=1, heads=2, ffn_dim=32, fsq_dim=8)
CAM_SMALL = dict(feat_dim=80, embedding_size=24, m_channels=4, init_channels=16, growth_rate=4,
                 bn_size=2, block_layers=(2, 2), block_dilations=(1, 2), seg_len=8)


class FakeTok:
    def encode(self, text):
        return [ord(c) % 200 + 1 for c in text][:8]


def _lm(C=128, eos_bias=0.0):
    """The LM at hidden C x 2 layers, f32, as a numpy tree; the head x 10
    (no near-ties), the EOS logit raised by eos_bias."""
    tcfg = cosy.default_config(hidden_size=C, num_layers=2, dtype=torch.float32)
    jcfg = jcosy.default_config(hidden_size=C, num_layers=2, dtype=jnp.float32, wkv_chunk=16,
                                remat=False)
    lm = bridge.params_to_numpy(cosy.init_params(torch.Generator().manual_seed(0), tcfg))
    lm["head"] = 10.0 * lm["head"]
    lm["head_bias"][EOS] = eos_bias
    return jcfg, tcfg, lm


def _prompt(B, T=16, seed=1):
    """A left-padded [SOS][text][TASK][speech] batch, row 1 padded by 3."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(2, 6000, (B, T)).astype(np.int32)
    modality = np.full((B, T), cosy.MOD_TEXT, np.int32)
    modality[:, 0] = modality[:, 10] = cosy.MOD_SPECIAL
    modality[:, 11:] = cosy.MOD_SPEECH
    mask = np.ones((B, T), np.int32)
    if B > 1:
        mask[1, :3] = modality[1, :3] = 0
    return tokens, modality, mask


def _jax_noise(key, n_steps, B):
    """JAX's draws of a run keyed `key`: step i's key splits into the
    nucleus and fallback draws of ras_sample."""
    pairs = [jax.random.split(k) for k in jax.random.split(key, n_steps)]
    g = lambda k, n: np.asarray(jax.random.gumbel(k, (B, n), jnp.float32))
    return (torch.from_numpy(np.stack([g(a, K) for a, _ in pairs])),
            torch.from_numpy(np.stack([g(b, V) for _, b in pairs])))


def _lengths(toks, n):
    toks = np.asarray(toks)
    is_eos = toks == EOS
    return np.where(is_eos.any(-1), np.argmax(is_eos, -1), n)


@pytest.mark.parametrize("route", ["decode_step", "b1_kernel"])
def test_cosy_generate_matches_jax_given_its_noise(route):
    """Rows that end at different steps (EOS raised, suppressed for 2
    steps), early exit after a chunk in which every row ended: JAX's tokens
    and lengths. decode_step: B=2 against JAX's cosy_generate; b1_kernel:
    B=1 against JAX's cosy_prefill_carry(mega_state) + cosy_decode_chunk
    through its B=1 kernel (interpret mode)."""
    jcfg, tcfg, lm = _lm(eos_bias=10.0)
    B = 2 if route == "decode_step" else 1
    n_new, key = 8, jax.random.PRNGKey(3)
    tokens, modality, mask = _prompt(B)
    jargs = [jnp.asarray(a) for a in (tokens, modality, mask)]
    jlm = jax.tree.map(jnp.asarray, lm)
    if route == "decode_step":
        want, want_len = jgen.cosy_generate(jrwkv7.pack_decode_params(jlm, jcfg.backbone), jcfg,
                                            *jargs, key, max_new_tokens=n_new, min_new_tokens=2)
        tparams, mega = rwkv7.pack_decode_params(bridge.params_from_numpy(lm), tcfg.backbone), None
    else:
        jmega = jdm.pack_mega(jlm, jcfg.backbone, 128)
        spec = jmega.pop("spec")
        carry = jgen.cosy_prefill_carry(jlm, jcfg, *jargs, mega_state=True)
        _, want, _ = jgen.cosy_decode_chunk(jlm, jcfg, carry, key, chunk_len=n_new,
                                            min_new_tokens=2, mega=jmega, mega_spec=spec)
        want_len = _lengths(want, n_new)
        tparams = bridge.params_from_numpy(lm)
        mega = dm.pack_mega(tparams, tcfg.backbone)
    got, got_len = tgen.cosy_generate(
        tparams, tcfg, *(torch.from_numpy(a).long() for a in (tokens, modality, mask)),
        max_new_tokens=n_new, min_new_tokens=2, mega=mega, chunk_len=4,
        noise=_jax_noise(key, n_new, B))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert (got_len.numpy() < n_new).all() and (got_len.numpy() >= 2).all()


def test_cosy_generate_mega_b64_matches_jax_interpret():
    """B=64 at 128 x 2, 4 steps at top-k 25 / top-p 0.8 with JAX's noise:
    the port's plain route against JAX's B=64 kernel in interpret mode."""
    jcfg, tcfg, lm = _lm()
    jlm = jax.tree.map(jnp.asarray, lm)
    jmega = jdmb.pack_mega_b64(jlm, jcfg.backbone, tile_n=128)
    spec = jmega.pop("spec")
    tokens, modality, mask = _prompt(dmb.B, seed=2)
    key = jax.random.PRNGKey(5)
    want, want_len = jgen.cosy_generate_mega_b64(
        jlm, jmega, spec, jcfg, *(jnp.asarray(a) for a in (tokens, modality, mask)), key,
        max_new_tokens=4)
    tlm = bridge.params_from_numpy(lm)
    got, got_len = tgen.cosy_generate_mega_b64(
        tlm, dmb.pack_mega_b64(tlm, tcfg.backbone), tcfg,
        *(torch.from_numpy(a).long() for a in (tokens, modality, mask)), max_new_tokens=4,
        noise=_jax_noise(key, 4, dmb.B))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------


def _numpy_params(shapes, seed):
    """A JAX parameter tree of the given shapes from a numpy seed."""
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = path[-1].key if hasattr(path[-1], "key") else ""
        x = rng.standard_normal(sd.shape)
        if name in ("g", "alpha", "var"):
            x = 1.0 + 0.1 * np.abs(x)
        elif sd.ndim == 1 or name.startswith("pos_bias"):
            x = 0.1 * x
        else:
            x = x / np.sqrt(max(1, int(np.prod(sd.shape[:-1]))))
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def pipes():
    """The JAX pipeline and the port's on one set of weights: LM 128 x 2,
    the tiny flow / HiFT, S3 (128 mels, one layer) and CAM++ small."""
    jcfg, tcfg, lm = _lm()
    shapes = lambda init, cfg: jax.eval_shape(lambda k: init(k, cfg), jax.random.PRNGKey(0))
    jf = jflow.FlowConfig(encoder=jconformer.UpsampleConformerConfig(**ENC),
                          estimator=jflow.EstimatorConfig(**EST), **FLOW)
    jh = jhift.HiFTConfig(**HIFT)
    js3c, jcpc = js3.S3TokenizerConfig(**S3_SMALL), jcp.CampplusConfig(**CAM_SMALL)
    trees = {n: _numpy_params(shapes(init, c), i) for i, (n, init, c) in enumerate((
        ("flow", jflow.init_params, jf), ("hift", jhift.init_params, jh),
        ("s3", js3.init_params, js3c), ("cam", jcp.init_params, jcpc)))}
    # the JAX frontends the JAX pipeline builds from s3_params / campplus_params
    # (s3.tokenize, campplus.embed_wav on one utterance), jitted
    tokenize = jax.jit(lambda w: js3.tokenize(trees["s3"], js3c, w[None])[0])
    embed = jax.jit(lambda w: jcp.embed_wav(trees["cam"], jcpc, w[None])[0])
    jpipe = JCosyPipeline(jcfg, lm, FakeTok(), jf, trees["flow"], jh, trees["hift"],
                          speech_tokenizer_fn=lambda w: np.asarray(tokenize(jnp.asarray(w))),
                          spk_embed_fn=lambda w: np.asarray(embed(jnp.asarray(w))))
    port = {n: bridge.codec_params_from_numpy(t) for n, t in trees.items()}
    tpipe = lambda **kw: CosyPipeline(
        tcfg, bridge.params_from_numpy(lm), FakeTok(),
        flow.FlowConfig(encoder=conformer.UpsampleConformerConfig(**ENC),
                        estimator=flow.EstimatorConfig(**EST), **FLOW), port["flow"],
        hift.HiFTConfig(**HIFT), port["hift"], s3_cfg=s3.S3TokenizerConfig(**S3_SMALL),
        s3_params=port["s3"], campplus_cfg=cp.CampplusConfig(**CAM_SMALL),
        campplus_params=port["cam"], device="cpu", **kw)
    return {"jax": jpipe, "decode_step": tpipe(), "b1_kernel": tpipe(decode_megakernel=True)}


def _clip(seed, seconds, sr):
    n = int(seconds * sr)
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * 180.0 * np.arange(n) / sr)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _spy(monkeypatch, pipe):
    seen = {}
    orig = pipe.generate_speech_tokens

    def spy(text, prompt_text="", prompt_speech_tokens=(), **kw):
        seen.update(prompt_text=prompt_text, lm_tokens=list(prompt_speech_tokens))
        return orig(text, prompt_text, prompt_speech_tokens, **kw)

    monkeypatch.setattr(pipe, "generate_speech_tokens", spy)
    return seen


def test_cross_lingual_and_instruct_prompts(pipes, monkeypatch):
    """The LM's prompt text and speech prompt of each mode (as
    tests/test_cosy_pipeline.py checks them for the JAX package); the flow
    keeps the whole prompt: tokens x 2 x 48 samples of finite audio."""
    pipe = pipes["decode_step"]
    seen = _spy(monkeypatch, pipe)
    prompt = dict(prompt_speech_tokens=[5, 6, 7], prompt_mel=np.zeros((6, 16), np.float32),
                  max_new_tokens=6)
    res = pipe.synthesize_cross_lingual("bonjour", **prompt)
    assert seen == {"prompt_text": "", "lm_tokens": []}
    assert res.wav.shape == (len(res.speech_tokens) * 96,) and np.isfinite(res.wav).all()
    pipe.synthesize_instruct("hello", "speak slowly", **prompt)
    assert seen == {"prompt_text": "speak slowly<|endofprompt|>", "lm_tokens": []}
    pipe.synthesize_instruct("hello", "speak slowly", prompt_text="hi there", **prompt)
    assert seen == {"prompt_text": "speak slowly<|endofprompt|>hi there", "lm_tokens": [5, 6, 7]}


@pytest.mark.parametrize("route", ["decode_step", "b1_kernel"])
def test_synthesize_from_a_prompt_wav(pipes, route):
    """Zero-shot from a wav on both decode routes: at least 2x and at most
    20x the content length in tokens, tokens x 96 finite samples, the
    seed's tokens again on a second call."""
    pipe = pipes[route]
    assert (pipe.lm_mega is None) == (route == "decode_step")
    clip = _clip(7, 1.0, 16000)
    res = pipe.synthesize("hello", prompt_wav=clip, max_new_tokens=12, seed=4)
    again = pipe.synthesize("hello", prompt_wav=clip, max_new_tokens=12, seed=4)
    assert 10 <= len(res.speech_tokens) <= 12
    assert res.wav.shape == (len(res.speech_tokens) * 96,) and np.isfinite(res.wav).all()
    np.testing.assert_array_equal(res.speech_tokens, again.speech_tokens)
    assert res.llm_s > 0 and res.flow_s > 0 and res.rtf > 0


def test_decode_route_follows_the_lm_and_the_device():
    """The B=1 kernel by default for a bf16 LM on a card, the model's decode
    step for an f32 LM or on the CPU; an explicit choice is kept, and the
    kernel refused for an f32 LM on a card."""
    from rwkvtts_torch.infer.cosy_pipeline import _kernel_route

    bf16 = cosy.default_config(hidden_size=128, num_layers=2).backbone
    f32 = cosy.default_config(hidden_size=128, num_layers=2, dtype=torch.float32).backbone
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert _kernel_route(None, cuda, bf16) is True
    assert _kernel_route(None, cpu, bf16) is False
    assert _kernel_route(None, cuda, f32) is False
    assert _kernel_route(False, cuda, bf16) is False
    assert _kernel_route(True, cpu, f32) is True
    with pytest.raises(ValueError, match="bf16"):
        _kernel_route(True, cuda, f32)


def test_voice_convert_never_runs_the_lm(pipes, monkeypatch):
    pipe = pipes["decode_step"]

    def no_lm(*a, **kw):
        raise AssertionError("voice conversion ran the LM")

    monkeypatch.setattr(tgen, "cosy_generate", no_lm)
    monkeypatch.setattr(tgen, "cosy_decode_chunk", no_lm)
    src = _clip(8, 0.8, 16000)
    res = pipe.voice_convert(src, prompt_wav=_clip(9, 0.6, 16000))
    np.testing.assert_array_equal(res.speech_tokens, pipe.speech_tokenizer_fn(src))
    assert len(res.speech_tokens) == 20 and res.llm_s == 0.0
    assert res.wav.shape == (20 * 96,) and np.isfinite(res.wav).all()


@pytest.mark.parametrize("speed", [0.8, 1.5])
def test_speed_resize_matches_jax_image_resize(pipes, speed):
    """The mel resize against jax.image.resize(..., "linear") (antialiased
    when it shrinks) within 1e-5, and token2wav's length at that speed."""
    pipe = pipes["decode_step"]
    mel = np.random.default_rng(10).standard_normal((1, 23, 16)).astype(np.float32)
    n = int(23 / speed)
    want = np.asarray(jax.image.resize(jnp.asarray(mel), (1, n, 16), "linear"))
    np.testing.assert_allclose(dsp.resize_linear(torch.from_numpy(mel), n).numpy(), want,
                               rtol=0, atol=1e-5)
    wav = pipe.token2wav(np.arange(7) + 100, n_timesteps=2, speed=speed)
    assert wav.shape == (int(14 / speed) * 48,) and np.isfinite(wav).all()


def test_refusals(pipes):
    pipe = pipes["decode_step"]
    args = (pipe.lm_cfg, bridge.params_from_numpy(_lm()[2]), FakeTok())
    # int4 and bf16 ranking are ported (tests/test_torch_quant.py); a quantize
    # flag on the B=1 kernel's route, or int8 with int4, is refused
    with pytest.raises(ValueError, match="decode_megakernel"):
        CosyPipeline(*args, quantize_int4=True, decode_megakernel=True, device="cpu")
    with pytest.raises(ValueError, match="exclusive"):
        CosyPipeline(*args, quantize_int8=True, quantize_int4=True, device="cpu")
    # the SFM flow runs (tests/test_torch_cosy_sfm.py); a stream that asks
    # for it on a flow without an SFM head is refused
    sfm = CosyPipeline.__new__(CosyPipeline)
    sfm.__dict__.update(pipe.__dict__)
    sfm.flow_cfg = dataclasses.replace(pipe.flow_cfg, sfm=True)
    with pytest.raises(ValueError, match="sfm_head"):
        next(streaming.stream_synthesize(sfm, "x", stream_cfg=streaming.StreamConfig(sfm=True)))
    tokens, modality, mask = (torch.from_numpy(a).long() for a in _prompt(1))
    with pytest.raises(ValueError, match="generator"):
        tgen.cosy_generate(pipe.lm_params, pipe.lm_cfg, tokens, modality, mask)
