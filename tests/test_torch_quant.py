"""Quantized decode in the port against the JAX package, on the CPU: the
int4 pack bit for bit, the model decode step on int4 and Cosy's unfused
int8 trees, the sampler's bf16 candidate ranking given JAX's noise,
CosyPipeline's int8 / int4 / bf16-ranked tokens given JAX's noise, the
launcher's --int8 / --int4 for both families and its refusals, the
quantized-decode quality probe's teacher-forced choices, and the
interactive console on a tiny pipeline. The JAX references are jitted
whole and compiled at XLA -O0. Weights come from the port's init
(a torch seed) and reach JAX as numpy; noise is JAX's, fed to the port."""
import functools
import io
import queue
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkvtts_tpu.infer import generate as jgen
from rwkvtts_tpu.models import cosy as jcosy
from rwkvtts_tpu.models import rwkv7 as jrwkv7
from rwkvtts_tpu.models import spark as jspark
from rwkvtts_tpu.ops import sampling as jsampling
from rwkvtts_torch import bridge
from rwkvtts_torch.codecs import bicodec
from rwkvtts_torch.codecs.spark_tokenizer import SparkAudioTokenizer
from rwkvtts_torch.convert import export_hf
from rwkvtts_torch.eval import quant_quality
from rwkvtts_torch.infer import generate as tgen
from rwkvtts_torch.infer.cosy_pipeline import CosyPipeline
from rwkvtts_torch.infer.spark_pipeline import SparkPipeline
from rwkvtts_torch.models import cosy, rwkv7, spark
from rwkvtts_torch.ops import sampling
from rwkvtts_torch.serving import http_server, interactive_cli, launch
from rwkvtts_torch.utils import audio_io

torch.set_num_threads(2)

C, L, HS, BATCH = 64, 2, 16, 3
EOS, V, K = 6561, 6562, 25


class FakeTok:
    def encode(self, text):
        return [ord(c) % 200 + 1 for c in text][:8]


def _leaves(tree, prefix=""):
    """{path: f32 (or integer) numpy array} of a tree of dicts of JAX or
    torch arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: (tree.float() if tree.is_floating_point() else tree).numpy()}
    a = np.asarray(tree)
    return {prefix: a.astype(np.float32) if a.dtype == jnp.bfloat16 else a}


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def weights():
    """Numpy weights of an RWKV-7 C x L at head size HS from the port's
    init, the loras, output and FFN value nonzero."""
    tcfg = rwkv7.RWKV7Config(vocab_size=32, hidden_size=C, num_layers=L, head_size=HS,
                             gate_lora=16, dtype=torch.float32)
    params = bridge.params_to_numpy(rwkv7.init_params(torch.Generator().manual_seed(0), tcfg))
    rng = np.random.default_rng(1)
    att, ffn = params["blocks"]["att"], params["blocks"]["ffn"]
    for tree, name in [(att, n) for n in ("w1", "a1", "v1", "g1", "output")] + [(ffn, "value")]:
        tree[name] = (0.3 * rng.standard_normal(tree[name].shape)).astype(np.float32)
    return params


class O0:
    """`fn` jitted (op by op each primitive compiles on its own), its first
    call's trace compiled at XLA -O0 (here the compile is most of a JAX
    reference's time), that program run on every call."""

    FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}

    def __init__(self, fn):
        self.jitted, self.compiled = jax.jit(fn), None

    def __call__(self, *args):
        if self.compiled is None:
            self.compiled = self.jitted.lower(*args).compile(compiler_options=self.FAST)
        return self.compiled(*args)


def _jpack(params, cfg, **kw):
    """JAX's pack_decode_params of a numpy tree, compiled at -O0."""
    return O0(lambda p: jrwkv7.pack_decode_params(p, cfg, **kw))(
        jax.tree.map(jnp.asarray, params))


def _cfgs(state_bf16=False, packed=False):
    kw = dict(vocab_size=32, hidden_size=C, num_layers=L, head_size=HS, gate_lora=16,
              decode_state_bf16=state_bf16, decode_wkv_packed=packed)
    return (jrwkv7.RWKV7Config(dtype=jnp.float32, wkv_chunk=4, remat=False, **kw),
            rwkv7.RWKV7Config(dtype=torch.float32, **kw))


def test_int4_pack_matches_jax_bit_for_bit(weights):
    """_quantize_int4 / _deq_int4 at in dims whose group of 64 shrinks (96
    -> 16, 64 -> 32) or stays (256), and every leaf of
    pack_decode_params(quantize_int4=True): equal bits; the refusals of
    int8 with int4 and of int4 without fused projections on both sides."""
    rng = np.random.default_rng(2)
    for shape, group in (((2, 96, 40), 64), ((3, 256, 24), 64), ((2, 64, 8), 16)):
        w = rng.standard_normal(shape).astype(np.float32)
        jq = O0(lambda x: jrwkv7._quantize_int4(x, group))(jnp.asarray(w))
        tq = rwkv7._quantize_int4(torch.from_numpy(w), group)
        np.testing.assert_array_equal(np.asarray(jq["q4"]), tq["q4"].numpy())
        np.testing.assert_array_equal(_leaves(jq)["s/"], _leaves(tq)["s/"])
        np.testing.assert_array_equal(
            np.asarray(O0(lambda q: jrwkv7._deq_int4(q, jnp.float32))(jq)),
            rwkv7._deq_int4(tq, torch.float32).numpy())
    jcfg, tcfg = _cfgs()
    jp = _leaves(_jpack(weights, jcfg, quantize_int4=True))
    tp = _leaves(rwkv7.pack_decode_params(bridge.params_from_numpy(weights), tcfg,
                                          quantize_int4=True))
    assert jp.keys() == tp.keys() and sum("_q4/" in k for k in tp) == 10
    for k in jp:
        np.testing.assert_array_equal(jp[k], tp[k], err_msg=k)
    assert tp["blocks/att/fused_a_q4/s/"].shape[-2] == C // 32  # the group shrank to 32
    for kw in (dict(quantize_int8=True, quantize_int4=True),
               dict(quantize_int4=True, fuse_projections=False)):
        with pytest.raises(ValueError):
            jrwkv7.pack_decode_params(weights, jcfg, **kw)
        with pytest.raises(ValueError):
            rwkv7.pack_decode_params(bridge.params_from_numpy(weights), tcfg, **kw)


# (the pack's keywords, bf16 state carry, in place)
DECODE_CASES = [
    (dict(quantize_int4=True), True, True),  # groups of 32 (C = 64) and 64 (the FFN's 4 C)
    (dict(quantize_int8=True, fuse_projections=False), False, True),  # Cosy's unfused int8
]


@pytest.mark.parametrize("pack,state_bf16,packed", DECODE_CASES)
def test_quantized_decode_step_matches_jax(weights, pack, state_bf16, packed):
    """Four chained decode steps on an int4 or unfused int8 tree, f32: the
    hidden within 1e-5 of JAX's (relative to its largest), the state too
    (2e-2 where it is carried in bf16)."""
    jcfg, tcfg = _cfgs(state_bf16, packed)
    rng = np.random.default_rng(7)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    state = {"att_x": f(L, BATCH, C), "wkv": 0.3 * f(L, BATCH, C // HS, HS, HS),
             "ffn_x": f(L, BATCH, C)}
    xs = [f(BATCH, C) for _ in range(4)]
    jp = jrwkv7.layer_decode_views(_jpack(weights, jcfg, **pack), jcfg)
    tp = rwkv7.layer_decode_views(
        rwkv7.pack_decode_params(bridge.params_from_numpy(weights), tcfg, **pack), tcfg)
    jst = jrwkv7.pack_decode_state(jax.tree.map(jnp.asarray, state), jcfg)
    tst = rwkv7.pack_decode_state(bridge.params_from_numpy(state), tcfg)
    jstep = O0(lambda p, x, s: jrwkv7.decode_step(p, jcfg, x, s))
    for x in xs:
        jh, jst = jstep(jp, jnp.asarray(x), jst)
        th, tst = rwkv7.decode_step(tp, tcfg, torch.from_numpy(x), tst)
        assert _rel(th.numpy(), jh) <= 1e-5
    jfin, tfin = jrwkv7.unpack_decode_state(jst, jcfg), rwkv7.unpack_decode_state(tst, tcfg)
    for k in ("att_x", "wkv", "ffn_x"):
        tol = 2e-2 if tfin[k].dtype == torch.bfloat16 else 1e-5
        assert _rel(tfin[k].float().numpy(), np.asarray(jfin[k].astype(jnp.float32))) <= tol, k


def _untied_logits(B, Vn, seed):
    """(B, Vn) f32 logits a row, a permutation of values 0.05 apart (each
    more than 3 bf16 ulps from its neighbours), so bf16 ranking has no
    ties."""
    rng = np.random.default_rng(seed)
    base = np.arange(Vn, dtype=np.float32) * 0.05 - 3.2
    return np.stack([rng.permutation(base) for _ in range(B)]).astype(np.float32)


def test_rank_bf16_sampling_matches_jax_given_its_noise():
    """sample(rank_bf16=True) and ras_sample(rank_bf16=True) pick JAX's
    tokens from JAX's Gumbel draws (the fallback's drawn in bf16), the
    fallback taken for some rows and not others; rank_bf16 where the
    fused branch cannot apply raises (JAX falls back without a word)."""
    B, Vn, k, p, temp = 4, 128, 20, 0.9, 0.7
    jsample = O0(functools.partial(jsampling.sample, temperature=temp, top_k=k, top_p=p,
                                   rank_bf16=True))
    jras = O0(functools.partial(jsampling.ras_sample, top_p=0.8, top_k=K, rank_bf16=True))
    recent = np.full((B, 10), -1, np.int32)
    n_fallback = 0
    for i in range(6):
        logits = _untied_logits(B, Vn, i)
        key = jax.random.PRNGKey(i)
        want = np.asarray(jsample(key, jnp.asarray(logits)))
        noise = torch.from_numpy(np.asarray(jax.random.gumbel(key, (B, k), jnp.float32)))
        got = sampling.sample(torch.from_numpy(logits), temperature=temp, top_k=k, top_p=p,
                              noise=noise, rank_bf16=True)
        np.testing.assert_array_equal(got.numpy(), want)
        # rows 0-1 have the likeliest tokens in their window: the fallback
        recent[:2] = np.argsort(-logits[:2], -1)[:, :10]
        want = np.asarray(jras(key, jnp.asarray(logits), jnp.asarray(recent)))
        k1, k2 = jax.random.split(key)
        noise = (torch.from_numpy(np.asarray(jax.random.gumbel(k1, (B, K), jnp.float32))),
                 torch.from_numpy(np.asarray(
                     jax.random.gumbel(k2, (B, Vn), jnp.bfloat16).astype(jnp.float32))))
        got = sampling.ras_sample(torch.from_numpy(logits), torch.from_numpy(recent).long(),
                                  top_p=0.8, top_k=K, noise=noise, rank_bf16=True)
        np.testing.assert_array_equal(got.numpy(), want)
        nucleus = sampling.ras_sample(torch.from_numpy(logits), torch.full((B, 10), -1),
                                      top_p=0.8, top_k=K, noise=noise, rank_bf16=True)
        n_fallback += int((got != nucleus).sum())
    assert 0 < n_fallback < 6 * B
    x = torch.from_numpy(_untied_logits(2, Vn, 0))
    for kw in (dict(top_k=0, top_p=0.9), dict(top_k=Vn, top_p=0.9), dict(top_k=k, top_p=1.0)):
        with pytest.raises(ValueError, match="rank_bf16"):
            sampling.sample(x, noise=torch.zeros(2, Vn), rank_bf16=True, **kw)


def _cosy_lm():
    """A Cosy LM 64 x 2 f32 as a numpy tree, the head x 10, EOS raised."""
    tcfg = cosy.default_config(hidden_size=64, num_layers=2, dtype=torch.float32)
    jcfg = jcosy.default_config(hidden_size=64, num_layers=2, dtype=jnp.float32, wkv_chunk=16,
                                remat=False)
    lm = bridge.params_to_numpy(cosy.init_params(torch.Generator().manual_seed(0), tcfg))
    lm["head"] = 10.0 * lm["head"]
    lm["head_bias"][EOS] = 8.0
    return jcfg, tcfg, lm


def _cosy_prompt(B=2, T=16):
    rng = np.random.default_rng(1)
    tokens = rng.integers(2, 6000, (B, T)).astype(np.int32)
    modality = np.full((B, T), cosy.MOD_TEXT, np.int32)
    modality[:, 0] = modality[:, 10] = cosy.MOD_SPECIAL
    modality[:, 11:] = cosy.MOD_SPEECH
    mask = np.ones((B, T), np.int32)
    mask[1, :3] = modality[1, :3] = 0
    return tokens, modality, mask


def _jax_ras_noise(key, n_steps, B, fallback_dtype=jnp.float32):
    """The draws of JAX's Cosy steps keyed `key`: step i's key splits into
    the nucleus (f32) and the fallback (in the logits' dtype) draws."""
    pairs = [jax.random.split(k) for k in jax.random.split(key, n_steps)]
    g = lambda k, n, dt: np.asarray(jax.random.gumbel(k, (B, n), dt).astype(jnp.float32))
    return (torch.from_numpy(np.stack([g(a, K, jnp.float32) for a, _ in pairs])),
            torch.from_numpy(np.stack([g(b, V, fallback_dtype) for _, b in pairs])))


# the pipeline's quantize keywords (the fused int8 tree's decode step is
# tests/test_torch_decode_step.py's)
PIPE_CASES = [dict(quantize_int8=True, fuse_projections=False), dict(quantize_int4=True)]


@pytest.mark.parametrize("quant", PIPE_CASES)
def test_cosy_pipeline_quantized_tokens_match_jax(quant):
    """CosyPipeline with unfused int8 or int4 decode weights: its packed
    tree equals the one the JAX CosyPipeline packs
    (rwkv7.pack_decode_params with the same flags), and cosy_generate on it
    gives JAX's tokens and lengths given JAX's draws (the rwkv7.decode_step
    route, which a quantize flag selects); decode_megakernel=True with a
    quantize flag raises."""
    jcfg, tcfg, lm = _cosy_lm()
    jparams = _jpack(lm, jcfg.backbone, **quant)
    pipe = CosyPipeline(tcfg, bridge.params_from_numpy(lm), FakeTok(), device="cpu", **quant)
    assert pipe.lm_mega is None and pipe.lm_rank_bf16 is False
    jl, tl = _leaves(jparams), _leaves(pipe.lm_params)
    assert jl.keys() == tl.keys()
    for k in jl:
        np.testing.assert_array_equal(jl[k], tl[k], err_msg=k)
    tokens, modality, mask = _cosy_prompt()
    n_new, key = 8, jax.random.PRNGKey(3)
    want, want_len = O0(lambda *a: jgen.cosy_generate(
        jparams, jcfg, *a, max_new_tokens=n_new, min_new_tokens=2))(
        *(jnp.asarray(a) for a in (tokens, modality, mask)), key)
    got, got_len = tgen.cosy_generate(pipe.lm_params, tcfg,
                                      *(torch.from_numpy(a).long() for a in (tokens, modality,
                                                                            mask)),
                                      max_new_tokens=n_new, min_new_tokens=2,
                                      noise=_jax_ras_noise(key, n_new, 2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    with pytest.raises(ValueError, match="decode_megakernel"):
        CosyPipeline(tcfg, bridge.params_from_numpy(lm), FakeTok(), device="cpu",
                     decode_megakernel=True, **quant)


def test_cosy_rank_bf16_chunk_matches_jax(monkeypatch):
    """CosyPipeline(sample_rank_bf16=True) stores the flag; a decode chunk
    with rank_bf16 (the bf16 logits, bias and ranking, the fallback in
    bf16) gives JAX's cosy_decode_chunk(rank_bf16=True) tokens given its
    draws, on the int8 tree; generate_speech_tokens passes the flag on."""
    jcfg, tcfg, lm = _cosy_lm()
    pipe = CosyPipeline(tcfg, bridge.params_from_numpy(lm), FakeTok(), device="cpu",
                        quantize_int8=True, sample_rank_bf16=True)
    assert pipe.lm_rank_bf16 is True
    jparams = _jpack(lm, jcfg.backbone, quantize_int8=True)
    tokens, modality, mask = _cosy_prompt()
    n_new, key = 6, jax.random.PRNGKey(5)
    _, want, _ = O0(lambda *a: jgen.cosy_decode_chunk(
        jparams, jcfg, jgen.cosy_prefill_carry(jparams, jcfg, *a[:3]), a[3], chunk_len=n_new,
        min_new_tokens=2, rank_bf16=True))(
        *(jnp.asarray(a) for a in (tokens, modality, mask)), key)
    carry = tgen.cosy_prefill_carry(pipe.lm_params, tcfg,
                                    *(torch.from_numpy(a).long() for a in (tokens, modality,
                                                                          mask)))
    _, got, _ = tgen.cosy_decode_chunk(pipe.lm_params, tcfg, carry,
                                       _jax_ras_noise(key, n_new, 2, jnp.bfloat16),
                                       min_new_tokens=2, rank_bf16=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # generate_speech_tokens (synthesize's LM stage) ranks in bf16 too; the
    # JAX pipeline's passes the flag only to its streaming path
    seen = []
    generate = tgen.cosy_generate
    monkeypatch.setattr(tgen, "cosy_generate",
                        lambda *a, **k: seen.append(k["rank_bf16"]) or generate(*a, **k))
    pipe.generate_speech_tokens("hello", max_new_tokens=4)
    assert seen == [True]


def _served(monkeypatch, argv):
    """The service launch.main builds, its HTTP serve stubbed out."""
    box = {}
    monkeypatch.setattr(http_server, "serve", lambda tts, *a, **k: box.update(tts=tts))
    launch.main(argv)
    return box["tts"]


def _hub_tokens(hub, tokens, seed):
    """The tokens of one request through the hub's pool (its pump)."""
    q = queue.Queue()
    with hub._lock:
        rid = hub.batcher.add_request(tokens, 12, min_new_tokens=4, seed=seed)
        hub._sinks[rid] = q
    hub._wake.set()
    out, done = [], False
    while not done:
        new, done, err = q.get(timeout=300)
        assert err is None
        out += list(np.asarray(new))
    return out


def test_launcher_int8_int4_both_families(tmp_path, monkeypatch):
    """launch.main --family cosy --int8 / --int4 --device cpu boots a
    service over the quantized tree and its pool answers a request; the
    Spark launcher packs --int4; --mega
    with --int4 or --int8, and --int8 with --int4, are refused."""
    monkeypatch.setattr("rwkvtts_torch.utils.tokenizer.get_world_tokenizer",
                        lambda n_spct=0: FakeTok())
    ccfg = cosy.default_config(hidden_size=64, num_layers=2, dtype=torch.float32)
    ckpt = export_hf.save_pretrained(cosy.init_params(torch.Generator().manual_seed(0), ccfg),
                                     ccfg, str(tmp_path / "cosy"), kind="cosy")
    ckpt = f"{ckpt}/model.safetensors"
    argv = ["--family", "cosy", "--ckpt", ckpt, "--n-slots", "2", "--chunk", "4", "--top-k",
            "1", "--no-warmup", "--device", "cpu"]
    from rwkvtts_torch.data import cosy_collator
    from rwkvtts_torch.data.spark_collator import pad_prompts_left

    prompt = pad_prompts_left([cosy_collator.build_prompt(FakeTok().encode("hello"), [])])
    for flag, key in (("--int8", "fused_a_q8"), ("--int4", "fused_a_q4")):
        tts = _served(monkeypatch, argv + [flag])
        try:
            assert key in tts.hub.pipe.lm_params["blocks"]["att"]
            toks = _hub_tokens(tts.hub, prompt, 7)
            assert 4 <= len(toks) <= 12 and all(0 <= t < V for t in toks)
        finally:
            tts.close()
    scfg = spark.default_config(hidden_size=32, num_layers=2, head_size=8, gate_lora=8,
                                dtype=torch.float32)
    sckpt = export_hf.save_pretrained(spark.init_params(torch.Generator().manual_seed(1), scfg),
                                      scfg, str(tmp_path / "spark"))
    sckpt = f"{sckpt}/model.safetensors"
    pipe = launch.build_pipeline(sckpt, int4=True, device="cpu")
    assert "fused_a_q4" in pipe.params["blocks"]["att"]
    assert "value_q4" in pipe.params["blocks"]["ffn"]
    for extra in (["--mega", "--int4"], ["--mega", "--int8"], ["--int8", "--int4"]):
        with pytest.raises(SystemExit):
            launch.main(["--ckpt", sckpt, "--device", "cpu", "--no-warmup"] + extra)


def test_quant_quality_forced_choices_match_jax(weights):
    """The probe's teacher-forced choices on an int8 tree equal those of
    JAX's decode_step on the same packed weights (a Spark C x L
    f32 with the blocks' zero-initialised matrices drawn nonzero, as the
    probe draws them); its record has the JAX script's keys for every mode (tiny, on
    the CPU)."""
    tcfg = spark.default_config(hidden_size=C, num_layers=L, head_size=HS, gate_lora=16,
                                dtype=torch.float32)
    jcfg = jspark.default_config(hidden_size=C, num_layers=L, head_size=HS, gate_lora=16,
                                 dtype=jnp.float32, wkv_chunk=16, remat=False)
    params = spark.init_params(torch.Generator().manual_seed(3), tcfg)
    quant_quality.nonzero_blocks(params, torch.Generator().manual_seed(5))
    tree = bridge.params_to_numpy(params)
    assert np.abs(tree["blocks"]["ffn"]["value"]).max() > 0
    tree["head"] = 10.0 * tree["head"]
    batch = quant_quality.prompts(2, "cpu")
    forced = torch.randint(0, 8000, (2, 8), generator=torch.Generator().manual_seed(4))

    @O0
    def jchoices(p, tokens, modality, mask, forced):
        h, state = jspark.prefill(p, jcfg, tokens, modality, mask)
        state = jrwkv7.pack_decode_state(state, jcfg.backbone)
        views = jrwkv7.layer_decode_views(p, jcfg.backbone)

        def step(carry, tok):
            h, st = carry
            choice = jnp.argmax(h @ p["head"], -1)
            h, st = jrwkv7.decode_step(views, jcfg.backbone, jspark.decode_embed(p, jcfg, tok),
                                       st)
            return (h, st), choice

        return jax.lax.scan(step, (h, state), forced.T)[1].T

    jp = _jpack(tree, jcfg.backbone, quantize_int8=True)
    tp = rwkv7.pack_decode_params(bridge.params_from_numpy(tree), tcfg.backbone,
                                  quantize_int8=True)
    want = jchoices(jp, *(jnp.asarray(t.numpy()) for t in batch), jnp.asarray(forced))
    got = quant_quality.forced_choices(tp, tcfg, *batch, forced)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the B=64 step takes C % 128 == 0
    recs = quant_quality.measure(quant_quality.MODES, hidden=128, layers=1, steps=3,
                                 device="cpu")
    for mode, rec in zip(quant_quality.MODES, recs):
        assert set(rec) == {"teacher_forced_top1_agreement", "free_running_token_agreement",
                            "median_first_divergence_step", "quant", "config", "wall_s"}
        assert 0.0 <= rec["teacher_forced_top1_agreement"] <= 1.0
        assert ("B=64" in rec["config"]) == (mode == "mega-b64") == rec["quant"].startswith(
            "mega")


def test_interactive_cli_scripted_session(tmp_path, monkeypatch):
    """repl over a tiny SparkPipeline with a tiny BiCodec: a designed voice
    (its five questions answered by default), a line, /seed, a clone of a
    written wav with its text, a line, /voice use of the saved design, a
    line, an unknown command, /quit: three nonempty wavs, nothing read
    after /quit; the module's entry builds its pipeline through launch,
    on the card unless told otherwise."""
    scfg = spark.default_config(hidden_size=32, num_layers=2, head_size=8, gate_lora=8,
                                dtype=torch.float32)
    lm = spark.init_params(torch.Generator().manual_seed(1), scfg)
    bcfg = _tiny_bicodec()
    codec = SparkAudioTokenizer(bcfg, bicodec.init_params(torch.Generator().manual_seed(2), bcfg),
                                wav2vec2=lambda w: torch.tanh(torch.as_tensor(
                                    np.asarray(w), dtype=torch.float32)[..., :(w.shape[-1] // 320) * 320]
                                    .reshape(*w.shape[:-1], -1, 320)[..., :12]))
    pipe = SparkPipeline(scfg, lm, FakeTok(), audio_tokenizer=codec)
    pipe.synthesize = functools.partial(pipe.synthesize, max_new_tokens=6)
    clip = tmp_path / "clip.wav"
    audio_io.save_wav(str(clip), 0.1 * np.sin(np.arange(16000) / 7.0).astype(np.float32), 16000)
    lines = (["/voice design"] + [""] * 5 + ["hello there", "/voice save d", "/seed 3",
             f"/voice clone {clip} some text", "a second line", "/voice use d", "third",
             "/bogus", "/quit", "never read"])
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(lines) + "\n"))
    out = tmp_path / "out"
    interactive_cli.repl(pipe, str(out))
    wavs = sorted(out.iterdir())
    assert [w.name for w in wavs] == ["tts_0000.wav", "tts_0001.wav", "tts_0002.wav"]
    for w in wavs:
        with wave.open(str(w)) as f:
            n = f.getnframes()
            samples = np.frombuffer(f.readframes(n), np.int16)
        assert n > 0 and np.abs(samples).max() > 0
    with pytest.raises(RuntimeError, match="CUDA"):
        interactive_cli.main(["--ckpt", "missing.safetensors", "--codec-dir", "none"])


def _tiny_bicodec():
    """The golden's reduced BiCodec with the LM's 8192-code semantic space
    and a 32-token speaker code (the pipeline's global tokens)."""
    bc = bicodec
    return bc.BiCodecConfig(
        mel=bc.MelParams(sample_rate=16000, n_fft=256, win_length=160, hop_length=80,
                         mel_fmin=10.0, mel_fmax=None, num_mels=32),
        encoder=bc.VocosStackConfig(12, 16, 32, 2, 10, sample_ratios=(2, 2)),
        quantizer_codebook_size=8192, quantizer_codebook_dim=4, quantizer_input_dim=10,
        prenet=bc.VocosStackConfig(10, 16, 32, 2, 12, sample_ratios=(2, 2), condition_dim=12),
        postnet=bc.VocosStackConfig(12, 16, 32, 2, 32),
        wave=bc.WaveGeneratorConfig(input_channel=12, channels=16, rates=(4, 2),
                                    kernel_sizes=(8, 4)),
        speaker=bc.SpeakerEncoderConfig(input_dim=32, out_dim=12, latent_dim=16, token_num=32,
                                        fsq_levels=(4, 4, 4, 4, 4, 4), fsq_num_quantizers=1))
