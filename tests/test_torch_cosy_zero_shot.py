"""Cosy zero-shot from a prompt wav, port vs JAX package, on the CPU:
frontend_zero_shot, and synthesize on both decode routes with the port
fed the JAX pipeline's draws. The pipelines of
tests/test_torch_cosy_pipeline.py (LM 128 x 2, the tiny flow / HiFT, S3
and CAM++ small, one set of weights through the bridge)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkvtts_tpu.codecs import flow as jflow
from rwkvtts_tpu.codecs import hift as jhift
from rwkvtts_tpu.infer import generate as jgen
from rwkvtts_tpu.ops import decode_mega as jdm
from rwkvtts_torch.codecs import flow, hift
from rwkvtts_torch.infer import generate as tgen

from test_torch_cosy_pipeline import _clip, _jax_noise, _lengths, _lm, pipes  # noqa: F401

torch.set_num_threads(2)


def test_frontend_zero_shot_matches_jax(pipes):
    """A 1.2 s clip at 24 kHz: the same S3 tokens, the prompt mel within
    1e-4 and the x-vector within 1e-4 relative to its largest value, mel
    frames = 2 x tokens."""
    jpipe, tpipe = pipes["jax"], pipes["decode_step"]
    clip = _clip(6, 1.2, 24000)
    jt, jm, je = jpipe.frontend_zero_shot(clip, prompt_sr=24000)
    tt, tm, te = tpipe.frontend_zero_shot(clip, prompt_sr=24000)
    np.testing.assert_array_equal(tt, np.asarray(jt))
    assert len(tt) == 30 and tm.shape == (60, 16) == np.shape(jm)
    np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-4)
    assert np.abs(te - je).max() <= 1e-4 * np.abs(je).max()



class _JaxFlowNoise:
    """flow.NoiseTable's interface over the JAX flow's CFM noise of a seed."""

    def __init__(self, seed, channels, device=None):
        self.key, self.channels = jax.random.PRNGKey(seed), channels

    def __call__(self, n_frames):
        return torch.from_numpy(np.array(
            jflow._positional_noise(self.key, (1, n_frames, self.channels))))


def _feed_jax_noise(monkeypatch):
    """The port's pipeline draws, as the JAX pipeline does, from the seed:
    the LM's per-step Gumbel noise of PRNGKey(seed), the flow's of
    PRNGKey(seed) and HiFT's sine source of PRNGKey(seed + 1) (the seeds
    read back from the generators the pipeline builds)."""
    generate, hift_inference = tgen.cosy_generate, hift.inference

    def cosy_generate(*a, generator, **kw):
        key = jax.random.PRNGKey(generator.initial_seed())
        return generate(*a, noise=_jax_noise(key, kw["max_new_tokens"], a[2].shape[0]), **kw)

    def hift_with_jax_draws(p, cfg, mel, cache_source=None, *, generator):
        k1, k2 = jax.random.split(jax.random.PRNGKey(generator.initial_seed()))
        H = cfg.nb_harmonics + 1
        phase = jax.random.uniform(k1, (1, H, 1), minval=-jnp.pi, maxval=jnp.pi)
        noise = jax.random.normal(k2, (1, H, mel.shape[1] * cfg.total_upsample))
        return hift_inference(p, cfg, mel, cache_source, phase=torch.from_numpy(np.array(phase)),
                              noise=torch.from_numpy(np.array(noise)))

    monkeypatch.setattr(tgen, "cosy_generate", cosy_generate)
    monkeypatch.setattr(flow, "NoiseTable", _JaxFlowNoise)
    monkeypatch.setattr(hift, "inference", hift_with_jax_draws)


def _jax_b1_generate():
    """JAX's cosy_generate through its B=1 kernel in interpret mode
    (cosy_prefill_carry(mega_state) + one cosy_decode_chunk): the JAX
    pipeline's own synthesize decodes through the XLA step whatever its
    decode_megakernel says."""
    jcfg, _, lm = _lm()
    jlm = jax.tree.map(jnp.asarray, lm)
    jmega = jdm.pack_mega(jlm, jcfg.backbone, 128)
    spec = jmega.pop("spec")

    def generate(params, cfg, tokens, modality, mask, key, *, max_new_tokens, **kw):
        carry = jgen.cosy_prefill_carry(jlm, cfg, tokens, modality, mask, mega_state=True)
        _, toks, _ = jgen.cosy_decode_chunk(jlm, cfg, carry, key, chunk_len=max_new_tokens,
                                            mega=jmega, mega_spec=spec, **kw)
        return toks, _lengths(toks, max_new_tokens)

    return generate


_jax_flow = jax.jit(jflow.inference, static_argnums=(1, 6), static_argnames="n_timesteps")
_jax_hift = jax.jit(jhift.inference, static_argnums=1)


@pytest.mark.parametrize("route", ["decode_step", "b1_kernel"])
def test_synthesize_matches_jax_given_its_noise(pipes, monkeypatch, route):
    """Zero-shot from the same 16 kHz wav, prompt text and seed, the port
    fed the JAX pipeline's draws: the JAX pipeline's speech tokens (the
    prompt it builds, the lengths from the content length, EOS) and its
    wav within 1e-3 of its largest sample (the prompt tokens, mel and
    x-vector handed to the flow). b1_kernel: the JAX side's LM through its
    B=1 kernel in interpret mode."""
    _feed_jax_noise(monkeypatch)
    # the JAX pipeline's flow and HiFT calls as compiled programs (op by op
    # each would compile every primitive)
    monkeypatch.setattr(jflow, "inference", _jax_flow)
    monkeypatch.setattr(jhift, "inference", _jax_hift)
    if route == "b1_kernel":
        monkeypatch.setattr(jgen, "cosy_generate", _jax_b1_generate())
    clip = _clip(11, 1.2, 16000)  # the frontend test's 16 kHz length: no new JAX compile
    kw = dict(prompt_text="a prompt", prompt_wav=clip, max_new_tokens=12, seed=5)
    want = pipes["jax"].synthesize("hello", **kw)
    got = pipes[route].synthesize("hello", **kw)
    np.testing.assert_array_equal(got.speech_tokens, np.asarray(want.speech_tokens))
    assert 2 <= len(got.speech_tokens) <= 12
    assert got.wav.shape == want.wav.shape == (len(got.speech_tokens) * 96,)
    assert np.isfinite(got.wav).all()
    assert np.abs(got.wav - want.wav).max() <= 1e-3 * np.abs(want.wav).max()
