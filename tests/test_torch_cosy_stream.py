"""The Cosy streaming slice, port vs JAX package, on the CPU: RAS sampling,
the codec convolutions through the bridge, the conformer, the windowed
flow hop, HiFT, and stream_synthesize end to end (the JAX side decoding
through its B=1 kernel in interpret mode, the port through the plain
version). Same weights through the bridge; the JAX package's random draws
fed to the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkvtts_tpu.codecs import conformer as jconformer
from rwkvtts_tpu.codecs import flow as jflow
from rwkvtts_tpu.codecs import hift as jhift
from rwkvtts_tpu.codecs import nn as jnn
from rwkvtts_tpu.infer import generate as jgen
from rwkvtts_tpu.infer import streaming as jstreaming
from rwkvtts_tpu.infer.cosy_pipeline import CosyPipeline as JCosyPipeline
from rwkvtts_tpu.models import cosy as jcosy
from rwkvtts_tpu.ops import sampling as jsampling
from rwkvtts_torch import bridge
from rwkvtts_torch.codecs import conformer, flow, hift, nn
from rwkvtts_torch.infer import generate as tgen
from rwkvtts_torch.infer import streaming
from rwkvtts_torch.infer.cosy_pipeline import CosyPipeline
from rwkvtts_torch.models import cosy
from rwkvtts_torch.ops import sampling

torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


# the tiny stack of tests/test_decode_mega.py:181-208
ENC = dict(input_size=24, output_size=24, attention_heads=2, linear_units=48, num_blocks=1,
           num_up_blocks=1)
EST = dict(in_channels=16 * 4, out_channels=16, channels=(16,), n_blocks=1, num_mid_blocks=1,
           num_heads=2, attention_head_dim=8, static_chunk_size=2)
FLOW = dict(input_size=24, output_size=16, spk_embed_dim=12, vocab_size=6562, n_timesteps=2)
HIFT = dict(in_channels=16, base_channels=32, nb_harmonics=2, upsample_rates=(4, 3),
            upsample_kernel_sizes=(8, 7), istft_n_fft=16, istft_hop_len=4,
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),),
            source_resblock_kernel_sizes=(7, 7),
            source_resblock_dilation_sizes=((1, 2), (1, 2)), f0_cond_channels=16)


def _numpy_params(shapes, seed):
    """A JAX parameter tree of the given shapes, filled from a numpy seed:
    gains near 1, biases small, weights at 1/sqrt(fan-in)."""
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = path[-1].key if hasattr(path[-1], "key") else ""
        x = rng.standard_normal(sd.shape)
        if name in ("g", "alpha"):
            x = 1.0 + 0.1 * x
        elif sd.ndim == 1 or name.startswith("pos_bias"):
            x = 0.1 * x
        else:
            x = x / np.sqrt(max(1, int(np.prod(sd.shape[:-1]))))
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def codecs():
    jf = jflow.FlowConfig(encoder=jconformer.UpsampleConformerConfig(**ENC),
                          estimator=jflow.EstimatorConfig(**EST), **FLOW)
    tf = flow.FlowConfig(encoder=conformer.UpsampleConformerConfig(**ENC),
                         estimator=flow.EstimatorConfig(**EST), **FLOW)
    jh, th = jhift.HiFTConfig(**HIFT), hift.HiFTConfig(**HIFT)
    shapes = lambda init, cfg: jax.eval_shape(lambda k: init(k, cfg), jax.random.PRNGKey(0))
    jfp = _numpy_params(shapes(jflow.init_params, jf), 1)
    jhp = _numpy_params(shapes(jhift.init_params, jh), 2)
    return {"jf": jf, "tf": tf, "jh": jh, "th": th, "jfp": jfp, "jhp": jhp,
            "tfp": bridge.codec_params_from_numpy(jfp), "thp": bridge.codec_params_from_numpy(jhp)}


# ---------------------------------------------------------------------------
# (c) RAS sampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("top_k,top_p", [(25, 0.8), (1, 1.0), (6562, 0.5)])
def test_ras_sample_matches_jax_given_its_noise(top_k, top_p):
    """Rows whose nucleus draw repeats in the window take the fallback
    branch, the others keep the draw; logits without ties."""
    rng = np.random.default_rng(4)
    B, V, win = 8, 6562, 10
    base = np.linspace(-6.0, 6.0, V, dtype=np.float32)
    logits = np.stack([rng.permutation(base) for _ in range(B)])
    key = jax.random.PRNGKey(5)
    k1, k2 = jax.random.split(key)
    k = min(top_k, V)
    noise = (torch.from_numpy(np.array(jax.random.gumbel(k1, (B, k), jnp.float32))),
             torch.from_numpy(np.array(jax.random.gumbel(k2, (B, V), jnp.float32))))
    no_rep = np.full((B, win), -1, np.int32)
    first = np.asarray(jsampling.ras_sample(key, jnp.asarray(logits), jnp.asarray(no_rep),
                                            top_p=top_p, top_k=top_k))
    recent = no_rep.copy()
    recent[::2, 3] = first[::2]  # even rows repeat their draw: the fallback
    want = np.asarray(jsampling.ras_sample(key, jnp.asarray(logits), jnp.asarray(recent),
                                           top_p=top_p, top_k=top_k))
    got = sampling.ras_sample(torch.from_numpy(logits), torch.from_numpy(recent).long(),
                              top_p=top_p, top_k=top_k, noise=noise)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[1::2] == first[1::2]).all() and (want[::2] != first[::2]).any()


def test_ras_sample_draws_from_a_generator():
    logits = torch.from_numpy(np.stack([np.random.default_rng(s).permutation(
        np.linspace(-6, 6, 100, dtype=np.float32)) for s in range(4)]))
    recent = torch.full((4, 10), -1)
    g = lambda: torch.Generator().manual_seed(5)
    a = sampling.ras_sample(logits, recent, top_k=25, generator=g())
    assert torch.equal(a, sampling.ras_sample(logits, recent, top_k=25, generator=g()))
    assert (torch.topk(logits, 25).indices == a[:, None]).any(-1).all()
    with pytest.raises(ValueError, match="noise"):
        sampling.ras_sample(logits, recent)


# ---------------------------------------------------------------------------
# (d) codecs: convolutions, conformer, flow hop, HiFT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,kw", [
    ("conv", dict(stride=1, padding="SAME_TORCH", dilation=3)),
    ("conv", dict(stride=3, padding=2, groups=2)),
    ("conv", dict(padding=(2, 0))),
    ("convT", dict(stride=4, padding=2)),
    ("convT", dict(stride=3, padding=2, output_padding=1)),
])
def test_codec_convolutions_match_jax_through_the_bridge(kind, kw):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 13, 8)).astype(np.float32)
    groups = kw.get("groups", 1)
    init = jnn.conv1d_init if kind == "conv" else jnn.conv_transpose1d_init
    p = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), 8, 6, 5, groups=groups))
    tp = bridge.codec_params_from_numpy({"ups": [p]} if kind == "convT" else {"c": p})
    tp = tp["ups"][0] if kind == "convT" else tp["c"]
    jfn, tfn = (jnn.conv1d, nn.conv1d) if kind == "conv" else (jnn.conv_transpose1d,
                                                              nn.conv_transpose1d)
    want = np.asarray(jfn(jax.tree.map(jnp.asarray, p), jnp.asarray(x), **kw))
    got = tfn(tp, torch.from_numpy(x), **kw).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-5


def test_conformer_matches_jax(codecs):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 11, 24)).astype(np.float32)
    mask = np.ones((1, 11), np.float32)
    mask[:, 9:] = 0
    want = jax.jit(jconformer.apply, static_argnums=1)(
        codecs["jfp"]["encoder"], codecs["jf"].encoder, jnp.asarray(x), jnp.asarray(mask))
    got = conformer.apply(codecs["tfp"]["encoder"], codecs["tf"].encoder, torch.from_numpy(x),
                          torch.from_numpy(mask))
    assert _rel(got.numpy(), want) <= 1e-4


def _flow_inputs(seed, P=4, W=12, n_valid=10):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 6561, (1, W))
    mask = (np.arange(W)[None] < n_valid).astype(np.float32)
    prompt_mel = rng.standard_normal((1, 2 * P, 16)).astype(np.float32)
    spk = rng.standard_normal((1, 12)).astype(np.float32)
    return tokens, mask, prompt_mel, spk


def test_flow_window_hop_matches_jax(codecs):
    """inference_window with gen_start 3, JAX's positional noise passed in."""
    tokens, mask, prompt_mel, spk = _flow_inputs(9)
    key = jax.random.PRNGKey(3)
    P, gen_start = 4, 3
    window = jax.jit(jflow.inference_window, static_argnums=(1, 6),
                     static_argnames=("n_timesteps",))
    want = window(codecs["jfp"], codecs["jf"], key, jnp.asarray(tokens), jnp.asarray(mask),
                  jnp.asarray(prompt_mel), P, jnp.int32(gen_start), jnp.asarray(spk),
                  n_timesteps=2)
    n_frames = 2 * (tokens.shape[1] + gen_start)
    table = torch.from_numpy(np.array(jflow._positional_noise(key, (1, n_frames, 16))))
    got = flow.inference_window(codecs["tfp"], codecs["tf"], torch.from_numpy(tokens),
                                torch.from_numpy(mask), torch.from_numpy(prompt_mel), P, gen_start,
                                torch.from_numpy(spk), table, n_timesteps=2)
    assert _rel(got.numpy(), want) <= 1e-4


def test_flow_window_equals_the_full_prefix(codecs):
    """A window covering the whole prefix (gen_start 0, no pad) gives the
    same frames as inference() over that prefix (as tests/test_streaming.py
    checks for the JAX package)."""
    P, G = 4, 6
    tokens, mask, prompt_mel, spk = _flow_inputs(10, P=P, W=P + G, n_valid=P + G)
    args = (torch.from_numpy(tokens), torch.from_numpy(mask), torch.from_numpy(prompt_mel))
    table = flow.NoiseTable(7, 16)(2 * (P + G))
    full = flow.inference(codecs["tfp"], codecs["tf"], *args, 2 * P, torch.from_numpy(spk),
                          table, n_timesteps=2)
    win = flow.inference_window(codecs["tfp"], codecs["tf"], *args, P, 0, torch.from_numpy(spk),
                                table, n_timesteps=2)
    np.testing.assert_allclose(full.numpy(), win[:, 2 * P:].numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("cached", [False, True])
def test_hift_matches_jax(codecs, cached):
    """hift.inference with JAX's phase and noise passed in, with and
    without a source cache."""
    rng = np.random.default_rng(11)
    T = 10
    mel = rng.standard_normal((1, T, 16)).astype(np.float32)
    cache = (0.1 * rng.standard_normal((1, 2 * 48))).astype(np.float32) if cached else None
    key = jax.random.PRNGKey(12)
    jcache = None if cache is None else jnp.asarray(cache)
    wav_j, src_j = jax.jit(jhift.inference, static_argnums=1)(
        codecs["jhp"], codecs["jh"], key, jnp.asarray(mel), jcache)
    k1, k2 = jax.random.split(key)
    H, n = codecs["jh"].nb_harmonics + 1, T * codecs["jh"].total_upsample
    phase = jax.random.uniform(k1, (1, H, 1), minval=-jnp.pi, maxval=jnp.pi)
    noise = jax.random.normal(k2, (1, H, n))
    wav_t, src_t = hift.inference(codecs["thp"], codecs["th"], torch.from_numpy(mel),
                                  None if cache is None else torch.from_numpy(cache),
                                  phase=torch.from_numpy(np.array(phase)),
                                  noise=torch.from_numpy(np.array(noise)))
    assert wav_t.shape == wav_j.shape
    assert _rel(src_t.numpy(), src_j) <= 1e-4
    assert _rel(wav_t.numpy(), wav_j) <= 1e-4


# ---------------------------------------------------------------------------
# (e) stream_synthesize end to end
# ---------------------------------------------------------------------------


class FakeTok:
    def encode(self, text):
        return [ord(c) % 200 + 1 for c in text][:8]


class JaxNoise:
    """The random draws of the JAX package's stream_synthesize(seed), in the
    port's noise-source interface (infer/streaming.SessionNoise)."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)
        self.flow_key = jax.random.PRNGKey(seed)
        self.hift_key = jax.random.PRNGKey(seed + 1)

    def lm(self, chunk, n_steps, k, vocab):
        self.key, sub = jax.random.split(self.key)
        draws = [jax.random.split(kk) for kk in jax.random.split(sub, n_steps)]
        g = lambda kk, n: np.asarray(jax.random.gumbel(kk, (1, n), jnp.float32))
        return (torch.from_numpy(np.stack([g(k1, k) for k1, _ in draws])),
                torch.from_numpy(np.stack([g(k2, vocab) for _, k2 in draws])))

    def flow_table(self, n_frames, channels):
        return torch.from_numpy(np.array(
            jflow._positional_noise(self.flow_key, (1, n_frames, channels))))

    def hift(self, hop, cfg, n_samples):
        k1, k2 = jax.random.split(jax.random.fold_in(self.hift_key, hop))
        H = cfg.nb_harmonics + 1
        phase = jax.random.uniform(k1, (1, H, 1), minval=-jnp.pi, maxval=jnp.pi)
        return (torch.from_numpy(np.array(phase)),
                torch.from_numpy(np.array(jax.random.normal(k2, (1, H, n_samples)))))


def _recording(monkeypatch, module, name, out):
    fn = getattr(module, name)

    def wrapped(*a, **kw):
        res = fn(*a, **kw)
        out.append(np.asarray(res[1]))
        return res

    monkeypatch.setattr(module, name, wrapped)


def _stream_vs_jax(codecs, monkeypatch, decode_megakernel):
    """Greedy LM (head x 10, top_k 1; the RAS fallback fed JAX's noise) at
    hidden 128 x 2, f32, with a 4-token speech prompt, its mel and a speaker
    embedding, both pipelines on one decode route: identical tokens, as
    many chunks, wav within 1e-3."""
    lm_cfg = jcosy.default_config(hidden_size=128, num_layers=2, dtype=jnp.float32,
                                  wkv_chunk=16, remat=False)
    tcfg = cosy.default_config(hidden_size=128, num_layers=2, dtype=torch.float32)
    lm = bridge.params_to_numpy(cosy.init_params(torch.Generator().manual_seed(0), tcfg))
    lm["head"] = 10.0 * lm["head"]
    rng = np.random.default_rng(13)
    prompt = dict(prompt_speech_tokens=[5, 17, 200, 6000],
                  prompt_mel=rng.standard_normal((8, 16)).astype(np.float32),
                  spk_embedding=rng.standard_normal(12).astype(np.float32))
    # two LM chunks of 2 (the carry crosses a chunk), a first hop of 1 token
    # + 3 lookahead, then the final hop: 4 decode steps
    stream_kw = dict(token_hop_len=1, ctx_tokens=4, mel_cache_len=2, n_timesteps=2, lm_chunk=2)
    kw = dict(max_new_tokens=4, top_k=1, seed=1, **prompt)

    jtoks, ttoks = [], []
    _recording(monkeypatch, jgen, "cosy_decode_chunk", jtoks)
    _recording(monkeypatch, tgen, "cosy_decode_chunk", ttoks)
    jpipe = JCosyPipeline(lm_cfg, lm, FakeTok(), flow_cfg=codecs["jf"], flow_params=codecs["jfp"],
                          hift_cfg=codecs["jh"], hift_params=codecs["jhp"],
                          decode_megakernel=decode_megakernel, mega_tile_n=128)
    want = list(jstreaming.stream_synthesize(
        jpipe, "hello", stream_cfg=jstreaming.StreamConfig(**stream_kw), **kw))

    tpipe = CosyPipeline(tcfg, bridge.params_from_numpy(lm), FakeTok(), flow_cfg=codecs["tf"],
                         flow_params=codecs["tfp"], hift_cfg=codecs["th"],
                         hift_params=codecs["thp"], decode_megakernel=decode_megakernel,
                         device="cpu")
    got = list(streaming.stream_synthesize(
        tpipe, "hello", stream_cfg=streaming.StreamConfig(**stream_kw), noise=JaxNoise(1), **kw))

    np.testing.assert_array_equal(np.concatenate(ttoks, 1), np.concatenate(jtoks, 1))
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
    assert _rel(np.concatenate(got), np.concatenate(want)) <= 1e-3


def test_stream_synthesize_matches_jax(codecs, monkeypatch):
    """The B=1 whole-step route: the JAX side decodes through its B=1
    kernel in interpret mode, the port through the plain version."""
    _stream_vs_jax(codecs, monkeypatch, decode_megakernel=True)


def test_stream_synthesize_on_the_decode_step_route_matches_jax(codecs, monkeypatch):
    """The model's decode-step route (the pipelines' default on the CPU
    and for an f32 LM): JAX's XLA step against the port's
    rwkv7.decode_step."""
    _stream_vs_jax(codecs, monkeypatch, decode_megakernel=False)


def _tiny_port_pipeline(codecs):
    cfg = cosy.default_config(hidden_size=128, num_layers=2, dtype=torch.float32)
    params = cosy.init_params(torch.Generator().manual_seed(0), cfg)
    params["head"] = 10.0 * params["head"]
    return CosyPipeline(cfg, params, FakeTok(), codecs["tf"], codecs["tfp"], codecs["th"],
                        codecs["thp"], decode_megakernel=True, device="cpu")


def test_stream_ramps_keep_the_tokens_and_the_audio_length(codecs, monkeypatch):
    """The hop ramp (hop_max), batched vocoding (vocode_every), the LM chunk
    ramp (lm_chunk_max) and the prefetch change when work is issued, not
    what is decoded: the same tokens, as many samples, fewer chunks."""
    pipe = _tiny_port_pipeline(codecs)
    base = dict(token_hop_len=2, ctx_tokens=4, mel_cache_len=2, n_timesteps=2, lm_chunk=2)
    runs = {}
    for name, extra in (("plain", dict(lm_prefetch=False)),
                        ("ramped", dict(hop_max=8, vocode_every=2, lm_chunk_max=5))):
        toks = []
        _recording(monkeypatch, tgen, "cosy_decode_chunk", toks)
        wav = list(streaming.stream_synthesize(
            pipe, "hello", stream_cfg=streaming.StreamConfig(**base, **extra),
            max_new_tokens=18, top_k=1, seed=2))
        monkeypatch.undo()
        runs[name] = (np.concatenate(toks, 1)[0, :18], wav)
    (t_a, w_a), (t_b, w_b) = runs["plain"], runs["ramped"]
    np.testing.assert_array_equal(t_a, t_b)
    frames = 2 * codecs["th"].total_upsample  # samples a token
    assert sum(map(len, w_a)) == sum(map(len, w_b)) >= 10 * frames
    assert sum(map(len, w_a)) % frames == 0 and len(w_b) < len(w_a)
    assert all(np.isfinite(c).all() for c in w_a + w_b)


def test_token2wav_gives_the_frames_of_the_tokens(codecs):
    pipe = _tiny_port_pipeline(codecs)
    rng = np.random.default_rng(14)
    wav = pipe.token2wav(rng.integers(0, 6561, 6), prompt_tokens=[1, 2, 3],
                         prompt_mel=rng.standard_normal((6, 16)).astype(np.float32),
                         spk_embedding=rng.standard_normal(12).astype(np.float32), n_timesteps=2)
    assert wav.shape == (6 * 2 * codecs["th"].total_upsample,) and np.isfinite(wav).all()
