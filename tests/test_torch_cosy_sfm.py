"""The SFM flow (codecs/flow.py's SFM head, sfm_inference and the windowed
hop), port vs JAX package, on the CPU: the head, the full and windowed
decodes fed JAX's positional noise, a window against the full sequence at
the same absolute frames, the sfm_head.* import, token2wav with an SFM
flow, a StreamConfig(sfm=True) stream against JAX's session with its
draws fed in, and a stored-voice request streamed through the port's
CosyTTSService (its hub on the launcher's --sfm config) against JAX's.
The tiny flow / HiFT of tests/test_cosy_pool.py with an SFM head; one set
of weights from a numpy seed through the bridge."""
import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden_configs as gc
from rwkvtts_tpu.codecs import conformer as jconformer
from rwkvtts_tpu.codecs import cosy_import as jcosy_import
from rwkvtts_tpu.codecs import flow as jflow
from rwkvtts_tpu.codecs import hift as jhift
from rwkvtts_tpu.infer import streaming as jstreaming
from rwkvtts_tpu.infer import voices as jvoices
from rwkvtts_tpu.infer.cosy_pipeline import CosyPipeline as JCosyPipeline
from rwkvtts_tpu.serving import service as jsvc
from rwkvtts_torch import bridge
from rwkvtts_torch.codecs import conformer, cosy_import, flow, hift
from rwkvtts_torch.infer import streaming, voices
from rwkvtts_torch.infer.cosy_pipeline import CosyPipeline
from rwkvtts_torch.serving import service as svc
from rwkvtts_torch.utils import fixtures

from test_torch_cosy_frontend import _numpy_params, _port_cfg, _same_tree
from test_torch_cosy_pool import EST, ENC, FLOW, HIFT, FakeTok, jax_noise, lm  # noqa: F401
from test_torch_cosy_stream import JaxNoise
from test_torch_cosy_zero_shot import _feed_jax_noise

torch.set_num_threads(2)

P, GEN_START = 4, 3
PROMPT = [5, 17, 200, 6000]


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


@pytest.fixture(scope="module")
def sfm():
    """The tiny SFM flow and HiFT: configs of both packages, the JAX
    trees from a numpy seed, the port's through the bridge."""
    jf = jflow.FlowConfig(encoder=jconformer.UpsampleConformerConfig(**ENC),
                          estimator=jflow.EstimatorConfig(**EST), sfm=True, **FLOW)
    tf = flow.FlowConfig(encoder=conformer.UpsampleConformerConfig(**ENC),
                         estimator=flow.EstimatorConfig(**EST), sfm=True, **FLOW)
    jh, th = jhift.HiFTConfig(**HIFT), hift.HiFTConfig(**HIFT)
    shapes = lambda init, cfg: jax.eval_shape(lambda k: init(k, cfg), jax.random.PRNGKey(0))
    jfp = _numpy_params(shapes(jflow.init_params, jf), 21)
    jhp = _numpy_params(shapes(jhift.init_params, jh), 22)
    # "free": the head as drawn, whose t_h + sigma_h clears 1 / sfm_strength;
    # then the start's noise scale sqrt((1 - t)^2 - sigma^2) is 0 up to
    # rounding (t + sigma = 1 after the Eq. 22 scaling) and its sqrt turns
    # f32 rounding into ~1e-4 of the noise, on either side. "clamped": the
    # head's t and log-sigma outputs biased low, so the scaling's max(., 1)
    # holds and the noise scale is well away from 0 (the default tree).
    free = jax.tree.map(np.copy, jfp)
    jfp["sfm_head"]["proj"]["b"][16:] = (-3.0, -4.0)
    trees = {"jfp": jfp, "jfp_free": free}
    return {"jf": jf, "tf": tf, "jh": jh, "th": th, "jhp": jhp,
            "thp": bridge.codec_params_from_numpy(jhp), **trees,
            **{"t" + k[1:]: bridge.codec_params_from_numpy(v) for k, v in trees.items()}}


_sfm_full = jax.jit(jflow.sfm_inference, static_argnums=1, static_argnames="n_timesteps")
_sfm_window = jax.jit(jflow.sfm_inference_window, static_argnums=(1, 5),
                      static_argnames="n_timesteps")


def _inputs(seed, W=12, n_valid=10):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 6561, (1, W))
    mask = (np.arange(W)[None] < n_valid).astype(np.float32)
    spk = rng.standard_normal((1, 12)).astype(np.float32)
    return tokens, mask, spk


def _check_head(sfm):
    h = np.random.default_rng(3).standard_normal((2, 9, 24)).astype(np.float32)
    want = jflow.sfm_head_apply(sfm["jfp"]["sfm_head"], jnp.asarray(h), 16)
    got = flow.sfm_head_apply(sfm["tfp"]["sfm_head"], torch.from_numpy(h), 16)
    for g, w in zip(got, want):
        assert g.shape == w.shape and _rel(g.numpy(), w) <= 1e-4


def _check_decode(sfm, which, start):
    """sfm_inference over a whole buffer and sfm_inference_window at
    gen_start 3, JAX's _positional_noise handed to the port: mel within
    1e-4 relative where the start's noise scale is well conditioned
    ("clamped"), within 1e-3 of the largest value where it is 0 up to
    rounding ("free", see the fixture)."""
    suffix = "" if start == "clamped" else "_free"
    jp, tp = sfm["jfp" + suffix], sfm["tfp" + suffix]
    tokens, mask, spk = _inputs(9)
    key = jax.random.PRNGKey(4)
    n_frames = 2 * (tokens.shape[1] + GEN_START)
    table = torch.from_numpy(np.array(jflow._positional_noise(key, (1, n_frames, 16))))
    t = (torch.from_numpy(tokens), torch.from_numpy(mask))
    j = (jnp.asarray(tokens), jnp.asarray(mask))
    if which == "full":
        want = _sfm_full(jp, sfm["jf"], key, *j, jnp.asarray(spk), n_timesteps=2)
        got = flow.sfm_inference(tp, sfm["tf"], *t, torch.from_numpy(spk), table, n_timesteps=2)
    else:
        want = _sfm_window(jp, sfm["jf"], key, *j, P, jnp.int32(GEN_START), jnp.asarray(spk),
                           n_timesteps=2)
        got = flow.sfm_inference_window(tp, sfm["tf"], *t, P, GEN_START, torch.from_numpy(spk),
                                        table, n_timesteps=2)
    assert got.shape == want.shape == (1, 24, 16)
    assert _rel(got.numpy(), want) <= (1e-4 if start == "clamped" else 1e-3)


def _check_window_vs_full(sfm):
    """A window at gen_start 0 over the whole prefix gives the full
    sequence's mel frame for frame; a window at gen_start 3 gives what the
    full decode of its buffer gives on the noise of its absolute frames."""
    G = 8
    tokens, _, spk = _inputs(10, W=P + G, n_valid=P + G)
    table = flow.NoiseTable(7, 16)(2 * (P + G + GEN_START))
    args = (torch.from_numpy(tokens), torch.ones(1, P + G))
    spk = torch.from_numpy(spk)
    full = flow.sfm_inference(sfm["tfp"], sfm["tf"], *args, spk, table, n_timesteps=2)
    win = flow.sfm_inference_window(sfm["tfp"], sfm["tf"], *args, P, 0, spk, table,
                                    n_timesteps=2)
    np.testing.assert_allclose(win.numpy(), full.numpy(), rtol=0, atol=1e-6)
    idx = flow.window_frames(P, GEN_START, 2 * (P + G), 2)
    shifted = flow.sfm_inference_window(sfm["tfp"], sfm["tf"], *args, P, GEN_START, spk, table,
                                        n_timesteps=2)
    at_abs = flow.sfm_inference(sfm["tfp"], sfm["tf"], *args, spk, table[:, idx], n_timesteps=2)
    np.testing.assert_allclose(shifted.numpy(), at_abs.numpy(), rtol=0, atol=1e-6)
    assert not np.allclose(shifted.numpy(), full.numpy())


def _check_import():
    """The golden flow state dict with a random sfm_head.*: the port's
    importer = the JAX importer + bridge.codec_params_from_numpy, leaf for
    leaf; without cfg.sfm both leave the head out."""
    sd, _ = fixtures.load_golden(os.path.join(gc.GOLDEN_DIR, "flow.npz"))
    rng = np.random.default_rng(5)
    C, M = 512, 80
    head = {"sfm_head.conv1.weight": (C, C, 3), "sfm_head.conv1.bias": (C,),
            "sfm_head.layernorm1.weight": (C,), "sfm_head.layernorm1.bias": (C,),
            "sfm_head.conv2.weight": (C, C, 3), "sfm_head.conv2.bias": (C,),
            "sfm_head.layernorm2.weight": (C,), "sfm_head.layernorm2.bias": (C,),
            "sfm_head.proj.weight": (M + 2, C), "sfm_head.proj.bias": (M + 2,)}
    sd = {**sd, **{k: rng.standard_normal(s).astype(np.float32) for k, s in head.items()}}
    for on in (True, False):
        jcfg = dataclasses.replace(gc.flow_config(), sfm=on)
        got = cosy_import.flow_from_state_dict(sd, _port_cfg(flow.FlowConfig, jcfg))
        want = jcosy_import.flow_from_state_dict(sd, jcfg)
        assert ("sfm_head" in got) == on == ("sfm_head" in want)
        _same_tree(got, bridge.codec_params_from_numpy(jax.tree.map(np.asarray, want)))


def _pipes(sfm, lm):
    jcfg, jtree, tcfg, tparams = lm
    jpipe = JCosyPipeline(jcfg, jtree, FakeTok(), sfm["jf"], sfm["jfp"], sfm["jh"], sfm["jhp"])
    tpipe = CosyPipeline(tcfg, tparams, FakeTok(), sfm["tf"], sfm["tfp"], sfm["th"], sfm["thp"],
                         device="cpu")
    return jpipe, tpipe


def _check_token2wav(sfm, lm, monkeypatch):
    """token2wav on an SFM flow (the SFM fast decode, the prompt's frames
    sliced off) with the JAX pipeline's flow and HiFT draws fed to the
    port: the wav within 1e-3 of its largest sample."""
    jpipe, tpipe = _pipes(sfm, lm)
    _feed_jax_noise(monkeypatch)
    # the JAX pipeline's own calls, jitted (the decode test's program)
    monkeypatch.setattr(jflow, "sfm_inference", _sfm_full)
    monkeypatch.setattr(jhift, "inference", jax.jit(jhift.inference, static_argnums=1))
    rng = np.random.default_rng(14)
    kw = dict(prompt_tokens=PROMPT, prompt_mel=rng.standard_normal((8, 16)).astype(np.float32),
              spk_embedding=rng.standard_normal(12).astype(np.float32), n_timesteps=2, seed=3)
    toks = rng.integers(0, 6561, 8)
    want = jpipe.token2wav(toks, **kw)
    got = tpipe.token2wav(toks, **kw)
    assert got.shape == want.shape == (8 * 96,) and np.isfinite(got).all()
    assert np.abs(got - np.asarray(want)).max() <= 1e-3 * np.abs(want).max()


def _check_stream(sfm, lm):
    """A CosyStreamSession with StreamConfig(sfm=True, vocode_every=2)
    against JAX's on one token stream arriving in two parts, the JAX
    session's draws fed to the port: as many chunks of the same lengths,
    the wav within 1e-3 of its largest sample; a flow without an sfm_head
    is refused."""
    jpipe, tpipe = _pipes(sfm, lm)
    stream_kw = dict(token_hop_len=2, ctx_tokens=4, mel_cache_len=2, n_timesteps=2, sfm=True,
                     vocode_every=2)
    rng = np.random.default_rng(13)
    prompt = (PROMPT, rng.standard_normal((8, 16)).astype(np.float32),
              rng.standard_normal(12).astype(np.float32))
    toks = rng.integers(0, 6561, 9)
    jsess = jstreaming.CosyStreamSession(jpipe, jstreaming.StreamConfig(**stream_kw), *prompt,
                                         seed=2)
    tsess = streaming.CosyStreamSession(tpipe, streaming.StreamConfig(**stream_kw), *prompt,
                                        JaxNoise(2))
    want, got = [], []
    for n, done in ((6, False), (9, True)):
        want += list(jsess.emit_ready(toks[:n], lm_done=done))
        with torch.inference_mode():
            got += list(tsess.emit_ready(toks[:n], lm_done=done))
    assert len(got) == len(want) == 3  # the first hop, hops 2-3 in one call, the rest
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
    assert _rel(np.concatenate(got), np.concatenate(want)) <= 1e-3
    plain = types.SimpleNamespace(**{**vars(tpipe), "flow_params": {
        k: v for k, v in tpipe.flow_params.items() if k != "sfm_head"}})
    with pytest.raises(ValueError, match="sfm_head"):
        streaming.CosyStreamSession(plain, streaming.StreamConfig(sfm=True), *prompt,
                                    JaxNoise(2))


def _check_service(sfm, lm, tmp_path, monkeypatch):
    """A stored-voice request streamed through JAX's CosyTTSService and the
    port's, both hubs on StreamConfig(sfm=True) as the launcher's --sfm
    builds them, the port fed the JAX pool's RAS draws and the JAX
    sessions' flow and HiFT draws: the same tokens, as many chunks of the
    same lengths, the wav within 1e-3 of its largest sample. This holds the
    service's and the hub's own logic to JAX's: the voice's prompt text and
    tokens in the prompt, the minimum and maximum lengths (2 and 20 times
    the content), and the seed passed to the pool and to the session."""
    jpipe, tpipe = _pipes(sfm, lm)
    rng = np.random.default_rng(15)
    jvoices.CosyVoiceLibrary(str(tmp_path)).register(
        "alice", PROMPT, rng.standard_normal((8, 16)).astype(np.float32),
        rng.standard_normal(12).astype(np.float32), prompt_text="hi")
    # _check_stream's config, so the JAX session's programs are compiled
    stream_kw = dict(token_hop_len=2, ctx_tokens=4, mel_cache_len=2, n_timesteps=2, sfm=True,
                     vocode_every=2)
    pool_kw = dict(n_slots=2, chunk=4, prompt_cap=32, max_new_tokens=12)
    theirs = jsvc.CosyTTSService(jpipe, voices=jvoices.CosyVoiceLibrary(str(tmp_path)),
                                 stream_cfg=jstreaming.StreamConfig(**stream_kw), **pool_kw)
    ours = svc.CosyTTSService(tpipe, voices=voices.CosyVoiceLibrary(str(tmp_path)),
                              stream_cfg=streaming.StreamConfig(**stream_kw), **pool_kw)
    ours.hub.batcher.noise = jax_noise
    monkeypatch.setattr(streaming, "SessionNoise", lambda seed, device=None: JaxNoise(seed))
    toks = {}
    for name, tts in (("jax", theirs), ("port", ours)):
        step, out = tts.hub.batcher.step, toks.setdefault(name, [])

        def recorded(step=step, out=out):
            events = step()
            for _, new, _ in events:
                out.extend(np.asarray(new).tolist())
            return events

        tts.hub.batcher.step = recorded
    try:
        want = list(theirs.stream(jsvc.TTSRequest(text="hey", speaker="alice", seed=3),
                                  hop_tokens=2))
        got = list(ours.stream(svc.TTSRequest(text="hey", speaker="alice", seed=3),
                               hop_tokens=2))
    finally:
        theirs.close()
        ours.close()
    # "hi" + "hey": 5 content tokens, so 10 drawn at least, 12 at most
    assert toks["port"] == toks["jax"] and 10 <= len(toks["jax"]) <= 12
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
    assert _rel(np.concatenate(got), np.concatenate(want)) <= 1e-3


# The tests, each a sequence of the checks above (two, so that xdist's
# load-by-file scheduler queues this file behind the long few-test files).


def test_sfm_flow_matches_jax(sfm):
    """The SFM head; the full and windowed decodes in both start regimes;
    a window against the full sequence; the sfm_head.* import."""
    _check_head(sfm)
    for which in ("full", "window"):
        for start in ("clamped", "free"):
            _check_decode(sfm, which, start)
    _check_window_vs_full(sfm)
    _check_import()


def test_sfm_synthesis_matches_jax(sfm, lm, monkeypatch, tmp_path):
    """A StreamConfig(sfm=True) stream against JAX's session; a stored-voice
    request through the port's CosyTTSService on an SFM hub against JAX's;
    then token2wav on an SFM flow against JAX's pipeline (its draws fed
    in)."""
    _check_stream(sfm, lm)
    _check_service(sfm, lm, tmp_path, monkeypatch)
    _check_token2wav(sfm, lm, monkeypatch)
